"""Training launcher: `python -m repro_torch.launch.train --arch <id> [...]`.

    python -m repro_torch.launch.train --arch qwen3-8b --reduced --device cpu --steps 20
    python -m repro_torch.launch.train --arch mamba2-130m --steps 100    # one CUDA GPU

The port of `repro.launch.train`: the fault-tolerant `Trainer` on one
device (cuda unless `--device cpu`), weights drawn from seed 0, the
synthetic token data, and the reference's printed JSON (`arch`, `steps`,
`first_loss`, `last_loss`, `wall_s`, `tokens_per_s`).  The mesh flags are
the reference's: one GPU has no production or multi-pod mesh
(`--production-mesh` / `--multi-pod` raise), `--data` and `--model` take
only 1, and `--grad-compress` (the int8 all-reduce over the pod axis) is a
no-op without a pod axis.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.launch.env import setup_env


def main(argv=None) -> dict:
    setup_env()  # before the first CUDA call
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="family-preserving tiny config (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-compress", action="store_true",
                    help="int8 gradient all-reduce across the pod axis (none on one GPU)")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--data", type=int, default=None, help="data axis size (1 on one GPU)")
    ap.add_argument("--model", type=int, default=1, help="model axis size (1 on one GPU)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.production_mesh or args.multi_pod:
        raise ValueError("--production-mesh / --multi-pod: one GPU has no such mesh")
    if args.data not in (None, 1) or args.model != 1:
        raise ValueError("--data / --model: one GPU takes only axis sizes of 1")

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import Trainer

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    ds = SyntheticTokenDataset(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.global_batch)
    trainer = Trainer(cfg=cfg, opt_cfg=AdamWConfig(lr=args.lr, total_steps=args.steps),
                      dataset=ds, ckpt_dir=args.ckpt_dir, grad_compress=args.grad_compress,
                      device=args.device)
    _, _, history, wall = trainer.run(0, args.steps)
    toks_per_s = args.steps * args.global_batch * args.seq / wall
    report = {
        "arch": cfg.name,
        "steps": args.steps,
        "first_loss": history[0]["loss"],
        "last_loss": history[-1]["loss"],
        "wall_s": round(wall, 1),
        "tokens_per_s": round(toks_per_s, 1),
    }
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
