"""The port's Mixture-of-Experts block (`repro_torch.models.moe`) against
the reference's (`repro.models.moe`).

Same numpy activations and weights through both on the CPU.  Ranks inside
an expert are integers: `array_equal`.  Routing: the port's top-k experts
equal `jax.lax.top_k` of the reference's gates (ties to the lower expert,
built here with duplicated router columns).  Outputs and the aux loss in
f32 at rtol = atol = 1e-4 (f32 sums in other orders); in bf16 within two
bf16 ulps of the output's scale (both round the expert products and the
shared branch to bf16, where one ulp may fall either way).  Cases: the
reduced phi3.5 shape (8 experts, top-2), a capacity factor of 1.0 that
drops assignments, DeepSeek's shared experts, and a decode-sized batch
below the capacity floor of 4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from _one_thread import one_thread  # noqa: E402,F401
from repro.models import moe as rmoe  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

F32_TOL = dict(rtol=1e-4, atol=1e-4)
D, E, F_ = 64, 8, 48


def _params(seed, n_shared=0, e=E, tie=False):
    rng = np.random.default_rng(seed)
    p = {"router": rng.normal(0, D**-0.5, (D, e)),
         "w_gate": rng.normal(0, D**-0.5, (e, D, F_)), "w_up": rng.normal(0, D**-0.5, (e, D, F_)),
         "w_down": rng.normal(0, F_**-0.5, (e, F_, D))}
    if tie:  # experts 1 and 5 score alike: their gates tie exactly
        p["router"][:, 5] = p["router"][:, 1]
    if n_shared:
        fs = F_ * n_shared
        p.update(shared_gate=rng.normal(0, D**-0.5, (D, fs)),
                 shared_up=rng.normal(0, D**-0.5, (D, fs)),
                 shared_down=rng.normal(0, fs**-0.5, (fs, D)))
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(p, dtype):
    """(reference tree, port dict): the router stays f32, as both inits keep it."""
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = {k: jnp.asarray(v) if k == "router" else jnp.asarray(v).astype(jd) for k, v in p.items()}
    port = {k: torch.from_numpy(v) if k == "router" else torch.from_numpy(v).to(td)
            for k, v in p.items()}
    return ref, port


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("n_experts", [1, 8, 160])
@pytest.mark.parametrize("tk", [1, 6, 500, 4096])
def test_rank_in_expert_equals_reference(tk, n_experts):
    flat_e = np.random.default_rng(tk + n_experts).integers(0, n_experts, tk).astype(np.int32)
    got = tmoe._rank_in_expert(torch.from_numpy(flat_e), n_experts)
    want = rmoe._rank_in_expert(jnp.asarray(flat_e), n_experts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # each expert's assignments rank 0, 1, ... in assignment order
    for e in np.unique(flat_e):
        np.testing.assert_array_equal(got.numpy()[flat_e == e], np.arange((flat_e == e).sum()))


@pytest.mark.parametrize("top_k", [1, 2, 6])
def test_routing_equals_reference_ties_included(top_k):
    """The same experts in the same order, ties to the lower expert (two
    router columns equal, so every token's gates for experts 1 and 5 tie)."""
    p = _params(top_k, tie=True)
    x = np.random.default_rng(7).normal(0, 1, (300, D)).astype(np.float32)
    gates, vals, idx = tmoe.route(torch.from_numpy(x), torch.from_numpy(p["router"]), top_k)
    w_gates = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["router"]), axis=-1)
    w_vals, w_idx = jax.lax.top_k(w_gates, top_k)
    np.testing.assert_allclose(gates.numpy(), np.asarray(w_gates), **F32_TOL)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(w_idx))
    w_vals = w_vals / jnp.sum(w_vals, -1, keepdims=True)
    np.testing.assert_allclose(vals.numpy(), np.asarray(w_vals), **F32_TOL)
    both = (idx.numpy() == 1).any(1) & (idx.numpy() == 5).any(1)
    assert not both.any() or (np.argmax(idx.numpy() == 1, 1) < np.argmax(idx.numpy() == 5, 1))[
        both].all()


CASES = {  # id: (batch, seq, top_k, capacity factor, shared experts)
    "phi3.5": (2, 24, 2, 1.25, 0),
    "drops": (2, 40, 2, 1.0, 0),
    "shared": (2, 24, 2, 1.25, 2),
    "decode": (3, 1, 2, 1.25, 1),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_block_matches_reference(case, dtype):
    b, s, top_k, cf, n_shared = CASES[case]
    p = _params(len(case), n_shared)
    x = np.random.default_rng(len(case) + 1).normal(0, 1, (b, s, D)).astype(np.float32)
    ref_p, port_p = _both(p, dtype)
    jx = jnp.asarray(x).astype(jnp.float32 if dtype == "float32" else jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.float32 if dtype == "float32" else torch.bfloat16)
    want, want_aux = rmoe.moe_block(jx, ref_p, E, top_k, cf, n_shared)
    got, aux = tmoe.moe_block(tx, port_p, E, top_k, cf, n_shared)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(float(aux), float(want_aux), **F32_TOL)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    else:
        scale = np.abs(_np(want)).max()
        np.testing.assert_allclose(_np(got), _np(want), rtol=2**-7, atol=2 * 2**-8 * scale)
    # the drop case drops (an expert gets more assignments than its
    # capacity), the decode batch never does (the floor of 4)
    t = b * s
    _, _, idx = tmoe.route(tx.reshape(t, D), port_p["router"], top_k)
    cap = tmoe.capacity_of(cf, top_k, t, E)
    most = np.bincount(idx.numpy().ravel(), minlength=E).max()
    if case in ("drops", "decode"):
        assert (most > cap) == (case == "drops"), (most, cap)


def test_capacity_formula():
    """The reference's float ceil with a floor of 4, capped at the tokens."""
    assert tmoe.capacity_of(1.25, 2, 8192, 16) == 1280
    assert tmoe.capacity_of(1.25, 6, 8192, 160) == 384
    assert tmoe.capacity_of(1.25, 2, 4, 16) == 4      # decode: the floor
    assert tmoe.capacity_of(1.25, 2, 3, 16) == 3      # never more than the tokens
    assert tmoe.capacity_of(160 / 6, 6, 1026, 160) == 1026
