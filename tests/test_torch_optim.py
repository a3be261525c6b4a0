"""The port's optimizer, schedule, token data and gradient compression
against the reference's, on the CPU.

`adamw_update` on f32 and bf16 leaves (three steps from a zero state, a
leaf sliced along its leading axis too) against `repro.optim.adamw_update`:
f32 within rtol 1e-6 of each element, or 1e-6 of the leaf's largest
magnitude (the global norm is summed in another order, so the clip scale
may differ by an ulp, and where b1 * mu + (1 - b1) * g cancels to near 0
that ulp is a larger share of the element); a bf16 parameter within one
bf16 ulp (it rounds the same f32 value, which may sit on the other side
of a rounding boundary).  `cosine_schedule` rtol 1e-6.  The token dataset and
`quantize` are equal to the reference's, array for array.  The pod
all-reduce at 4 pods against `compressed_psum_pods` under `shard_map` on 4
host devices (a subprocess: the device count is fixed at JAX's start),
rtol 1e-6 (the f32 sum of the four scales in another order).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from _one_thread import one_thread  # noqa: E402,F401
from repro.data import SyntheticTokenDataset as RefDataset  # noqa: E402
from repro.optim import AdamWConfig as RefAdamW  # noqa: E402
from repro.optim import adamw_update as ref_adamw  # noqa: E402
from repro.optim import cosine_schedule as ref_cosine  # noqa: E402
from repro.optim import init_opt_state as ref_init_opt  # noqa: E402
from repro.training.compression import quantize as ref_quantize  # noqa: E402
from repro_torch.data import SyntheticTokenDataset  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_update, cosine_schedule, init_opt_state  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.training.compression import compressed_psum_pods, quantize  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
SHAPES = {"w": (6, 5), "stack": (4, 3, 8), "b": (7,), "s": ()}


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(dtype, sliced, monkeypatch):
    if sliced:  # every leaf above 8 elements updated in row slices
        monkeypatch.setattr(t_adamw, "SLICE_ELEMENTS", 8)
    rng = np.random.default_rng(0)
    p0 = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in SHAPES.items()}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref_p = {k: jnp.asarray(v).astype(jdt) for k, v in p0.items()}
    port_p = {k: torch.tensor(np.asarray(jnp.asarray(v).astype(jnp.float32))).to(tdt)
              for k, v in ref_p.items()}
    cfg = dict(lr=0.05, weight_decay=0.1, clip_norm=1.0)
    ref_s, port_s = ref_init_opt(ref_p), init_opt_state(port_p)
    for step in range(3):
        g = {k: rng.normal(0, 0.7, s).astype(np.float32) for k, s in SHAPES.items()}
        ref_g = {k: jnp.asarray(v).astype(jdt) for k, v in g.items()}
        port_g = {k: torch.tensor(np.asarray(jnp.asarray(v).astype(jnp.float32))).to(tdt)
                  for k, v in ref_g.items()}
        lr = 0.05 * (step + 1) / 3
        ref_p, ref_s, ref_m = ref_adamw(ref_p, ref_g, ref_s, RefAdamW(**cfg), lr)
        port_p, port_s, port_m = adamw_update(port_p, port_g, port_s, AdamWConfig(**cfg), lr)
        np.testing.assert_allclose(float(port_m["grad_norm"]), float(ref_m["grad_norm"]),
                                   rtol=1e-6)
        assert float(port_m["lr"]) == np.float32(lr)
        assert int(port_s["step"]) == int(ref_s["step"]) == step + 1
        for k in SHAPES:
            for part in ("mu", "nu"):
                want = np.asarray(ref_s[part][k])
                np.testing.assert_allclose(port_s[part][k].numpy(), want, rtol=1e-6,
                                           atol=1e-6 * np.abs(want).max(), err_msg=f"{part} {k}")
            got = port_p[k].float().numpy()
            want = np.asarray(jnp.asarray(ref_p[k]).astype(jnp.float32))
            assert port_p[k].dtype == tdt
            if dtype == "float32":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max(),
                                           err_msg=k)
            else:
                assert (np.abs(got - want) <= _bf16_ulp(want)).all(), k


def test_adamw_step_math():
    """The twin of `test_trainer.py::test_adamw_step_math`."""
    params = {"w": torch.ones(4)}
    grads = {"w": torch.full((4,), 0.5)}
    state = init_opt_state(params)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, clip_norm=100.0)
    new, state, m = adamw_update(params, grads, state, cfg, 0.1)
    # first step: mhat = g, vhat = g^2 -> delta ~ 1 -> p ~ 1 - 0.1
    np.testing.assert_allclose(new["w"].numpy(), 0.9, atol=1e-4)
    assert float(m["grad_norm"]) == pytest.approx(1.0, rel=1e-5)


def test_adamw_missing_grad_counts_as_zero():
    """A parameter without a gradient is decayed and its moments decay,
    as the reference's zero gradient does."""
    rng = np.random.default_rng(2)
    p = rng.normal(0, 1, (5,)).astype(np.float32)
    ref_p, ref_s, _ = ref_adamw({"a": jnp.asarray(p)}, {"a": jnp.zeros(5)},
                                ref_init_opt({"a": jnp.asarray(p)}), RefAdamW(), 0.1)
    got, st, _ = adamw_update({"a": torch.from_numpy(p.copy())}, {"a": None},
                              init_opt_state({"a": torch.from_numpy(p)}), AdamWConfig(), 0.1)
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(ref_p["a"]), rtol=1e-6)


def test_cosine_schedule_matches_reference():
    for cfg in (dict(lr=3e-4, warmup_steps=2, total_steps=12),
                dict(lr=1.0, warmup_steps=10, total_steps=110, min_lr_ratio=0.1),
                dict(lr=1e-3, warmup_steps=0, total_steps=5)):
        got = [float(cosine_schedule(s, AdamWConfig(**cfg))) for s in range(cfg["total_steps"] + 3)]
        want = [float(ref_cosine(s, RefAdamW(**cfg))) for s in range(cfg["total_steps"] + 3)]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        # a tensor step (the optimizer's int32 counter) gives the same values
        t = float(cosine_schedule(torch.tensor(3, dtype=torch.int32), AdamWConfig(**cfg)))
        assert t == got[3]


def test_cosine_schedule_shape():
    """The twin of `test_trainer.py::test_cosine_schedule_shape`."""
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
    assert float(cosine_schedule(0, cfg)) == 0.0
    assert float(cosine_schedule(10, cfg)) == pytest.approx(1.0)
    assert float(cosine_schedule(110, cfg)) == pytest.approx(0.1, rel=1e-3)


@pytest.mark.parametrize("seed,n_shards", [(0, 1), (3, 2), (11, 4)])
def test_dataset_equals_reference(seed, n_shards):
    for shard in range(n_shards):
        kw = dict(vocab_size=1000, seq_len=32, global_batch=8, seed=seed, n_shards=n_shards,
                  shard=shard)
        port, ref = SyntheticTokenDataset(**kw), RefDataset(**kw)
        assert port.local_batch == ref.local_batch
        for step in (0, 1, 7, 123):
            got, want = port.batch(step), ref.batch(step)
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(port.frontend_embeddings(step, 5, 16),
                                          ref.frontend_embeddings(step, 5, 16))


def test_dataset_deterministic_and_sharded():
    """The twin of `test_trainer.py::test_dataset_deterministic_and_sharded`."""
    ds = SyntheticTokenDataset(1000, 32, 8, seed=3)
    np.testing.assert_array_equal(ds.batch(7), ds.batch(7))
    assert not np.array_equal(ds.batch(7), ds.batch(8))
    d0 = SyntheticTokenDataset(1000, 32, 8, seed=3, n_shards=2, shard=0)
    d1 = SyntheticTokenDataset(1000, 32, 8, seed=3, n_shards=2, shard=1)
    assert d0.batch(5).shape == (4, 32)
    assert not np.array_equal(d0.batch(5), d1.batch(5))


@pytest.mark.parametrize("scale", [0.1, 1e-3, 0.0])
def test_quantize_equals_reference(scale):
    rng = np.random.default_rng(1)
    g = rng.normal(0, 1, (1000,)).astype(np.float32)
    g[:2] = [127.0, -63.5]  # scale 1: -63.5 is a half, rounded to even
    g *= np.float32(scale)
    q, s = quantize(torch.from_numpy(g))
    rq, rs = ref_quantize(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)


def test_int8_quantize_bounded_error():
    """The twin of `test_trainer.py::test_int8_quantize_bounded_error`."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(0, 0.1, (1000,)).astype(np.float32))
    q, s = quantize(g)
    err = np.abs(q.numpy().astype(np.float32) * float(s) - g.numpy())
    assert err.max() <= float(s) * 0.5 + 1e-9  # half-ulp of the int8 grid


POD_PROBE = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.training.compression import compressed_psum_pods
grads = {k: np.asarray(v, np.float32) for k, v in json.loads(sys.stdin.read()).items()}
mesh = Mesh(np.asarray(jax.devices()[:4]), ("pod",))
f = jax.shard_map(lambda g: jax.tree.map(lambda x: x[None], compressed_psum_pods(
    jax.tree.map(lambda x: x[0], g), mesh)), mesh=mesh, in_specs=P("pod"), out_specs=P("pod"),
    check_vma=False)
out = jax.jit(f)({k: jnp.asarray(v) for k, v in grads.items()})
print(json.dumps({k: np.asarray(v).tolist() for k, v in out.items()}))
"""


def test_pod_allreduce_matches_reference():
    """4 pods' gradients, stacked along the leading axis: the port's reduced
    leaf against the value each pod holds after the reference's shard_map."""
    rng = np.random.default_rng(5)
    grads = {"a": rng.normal(0, 1, (4, 6, 3)).astype(np.float32),
             "b": (rng.normal(0, 1, (4, 5)) * np.array([[1.0], [1e-3], [10.0], [0.1]]))
             .astype(np.float32)}
    env = {"PYTHONPATH": str(SRC), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    out = subprocess.run([sys.executable, "-c", POD_PROBE], capture_output=True, text=True,
                         env=env, input=json.dumps({k: v.tolist() for k, v in grads.items()}),
                         timeout=300)
    assert out.returncode == 0, out.stderr
    want = {k: np.asarray(v, np.float32) for k, v in json.loads(out.stdout).items()}
    got = compressed_psum_pods({k: torch.from_numpy(v) for k, v in grads.items()})
    for k in grads:
        assert got[k].shape == grads[k].shape[1:]
        for pod in range(4):  # every pod holds the same reduced value
            np.testing.assert_allclose(got[k].numpy(), want[k][pod], rtol=1e-6, atol=0)
