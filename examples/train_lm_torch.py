"""End-to-end training on the PyTorch/CUDA port: a ~100M-parameter
qwen3-family LM for a few hundred steps on synthetic data with the
fault-tolerant Trainer (checkpointing + restart + deterministic data) --
the twin of `examples/train_lm.py`, on one device and without a mesh.

    PYTHONPATH=src python examples/train_lm_torch.py --ckpt-dir DIR [--steps 200] [--device cpu]

A train step runs no kernel of the port (the flash kernel serves only the
cached prefill, as in the reference).  The size flags shrink the model
for a CPU run; their defaults are the reference's ~100M model.
"""

import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokenDataset
from repro_torch.optim import AdamWConfig
from repro_torch.training import Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", required=True, help="where the checkpoints go")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--d-model", type=int, default=512, help="8 heads of d_model / 8")
    ap.add_argument("--vocab", type=int, default=32064)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=20)
    args = ap.parse_args(argv)

    # ~100M params: qwen3 family scaled down (12 layers x 512 wide, 32k vocab)
    d = args.d_model
    cfg = dataclasses.replace(
        get_config("qwen3-8b"),
        n_layers=args.layers, d_model=d, n_heads=8, n_kv_heads=4, head_dim=d // 8,
        d_ff=3 * d, vocab_size=args.vocab, dtype="float32", remat=False,
    )
    print(f"model: {cfg.n_params()/1e6:.1f}M params")

    ds = SyntheticTokenDataset(cfg.vocab_size, seq_len=args.seq, global_batch=args.batch)
    trainer = Trainer(
        cfg=cfg,
        opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=args.warmup, total_steps=args.steps),
        dataset=ds,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        device=args.device,
    )
    params, opt, history, wall = trainer.run(0, args.steps)
    tok_per_s = args.steps * args.batch * args.seq / wall
    print(
        f"steps {history[0]['step']}..{history[-1]['step']}: "
        f"loss {history[0]['loss']:.3f} -> {history[-1]['loss']:.3f} "
        f"({tok_per_s:.0f} tok/s)"
    )
    assert history[-1]["loss"] < history[0]["loss"], "loss should decrease"
    return {"first_loss": history[0]["loss"], "last_loss": history[-1]["loss"],
            "tok_per_s": tok_per_s, "n_params": cfg.n_params(),
            "tensors": {"params": dict(params.named_parameters()), "opt": opt}}


if __name__ == "__main__":
    main()
