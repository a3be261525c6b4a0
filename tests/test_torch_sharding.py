"""The port's partition rules (`repro_torch.models.sharding`) against the
reference's `repro.models.sharding`, without devices.

The cases of `tests/test_sharding.py` on the port's mesh descriptions, and
for every config of `ARCH_IDS` the spec of every parameter and of every
decode-cache entry equal to `tuple(fit_spec(param_spec_for(...)))` /
`tuple(fit_spec(cache_spec(...)))` of the reference, on
`jax.sharding.AbstractMesh` of (4, 2), of the pod (16, 16) and of the
multi-pod (2, 16, 16): the reference's shapes from `jax.eval_shape`, the
port's from a `DecoderLM` and a cache on the meta device, a per-layer
tensor's spec the reference's stacked spec without its leading None.
Exact equality: these are names and integers (a one-axis entry in the
canonical form `PartitionSpec` gives it, the bare name).
"""

import functools

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import PartitionSpec as P  # noqa: E402

from _one_thread import one_thread  # noqa: E402,F401
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import init_decode_cache as ref_init_cache  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models import sharding as ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import _reference_key  # noqa: E402
from repro_torch.models import DecoderLM, init_decode_cache  # noqa: E402
from repro_torch.models import sharding as port  # noqa: E402

MESHES = {
    "4x2": ((4, 2), ("data", "model")),
    "pod": ((16, 16), ("data", "model")),
    "multipod": ((2, 16, 16), ("pod", "data", "model")),
}


def _abstract_mesh(sizes, names):
    try:  # jax >= 0.5 signature: (sizes, names)
        return jax.sharding.AbstractMesh(sizes, names)
    except TypeError:  # jax 0.4.x signature: ((name, size), ...)
        return jax.sharding.AbstractMesh(tuple(zip(names, sizes)))


def _meshes(name):
    sizes, names = MESHES[name]
    return _abstract_mesh(sizes, names), dict(zip(names, sizes))


@pytest.fixture
def mesh():
    return {"data": 4, "model": 2}


def test_param_rules(mesh):
    assert port.param_spec_for(("embed",), 2, mesh) == ("model", None)
    assert port.param_spec_for(("layers", "attn", "wq"), 3, mesh) == (None, "data", "model")
    assert port.param_spec_for(("layers", "mlp", "w_down"), 3, mesh) == (None, "model", "data")
    assert port.param_spec_for(("layers", "moe", "w_gate"), 4, mesh) == (
        None, "model", "data", None)
    assert port.param_spec_for(("layers", "ln1"), 2, mesh) == ()


def test_fit_spec_drops_nondivisible(mesh):
    assert port.fit_spec(("model", "data"), (50280, 768), mesh) == ("model", "data")
    assert port.fit_spec(("data", None), (50281, 768), mesh) == (None, None)
    m3 = {"pod": 2, "data": 4, "model": 2}
    assert port.fit_spec((("pod", "data"),), (2,), m3) == ("pod",)
    assert port.fit_spec((("pod", "data"),), (8,), m3) == (("pod", "data"),)
    assert port.fit_spec((("pod", "data"),), (1,), m3) == (None,)


def test_mesh_axes_and_batch_spec(mesh):
    dp, fsdp, tp = port.mesh_axes(mesh)
    assert dp == ("data",) and fsdp == "data" and tp == "model"
    assert port.batch_spec(mesh) == ("data", None)
    assert port.batch_spec({"pod": 2, "data": 4, "model": 2}) == (("pod", "data"), None)
    assert port.batch_spec(port.MESHES["card"]) == (None, None)


def test_cache_spec_batch_vs_seq(mesh):
    cfg = get_config("yi-6b")
    assert port.cache_spec(cfg, "k", mesh, batch=8) == (None, "data", None, "model", None)
    assert port.cache_spec(cfg, "k", mesh, batch=1) == (None, None, "data", "model", None)
    assert port.cache_spec(cfg, "ssm", mesh, batch=8) == (None, "data", "model", None, None)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_basic_cases_equal_reference(mesh_name):
    amesh, pmesh = _meshes(mesh_name)
    assert port.mesh_axes(pmesh) == ref.mesh_axes(amesh)
    for seq in (False, True):
        assert port.batch_spec(pmesh, seq) == tuple(ref.batch_spec(amesh, seq))
    for spec, shape in [(("model", "data"), (50280, 768)), (("data", None), (50281, 768)),
                        ((("data", "model"), None), (64, 3)), ((None, "model"), (5, 7))]:
        assert port.fit_spec(spec, shape, pmesh) == tuple(ref.fit_spec(P(*spec), shape, amesh))


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    cfg = ref_get_config(arch)
    params = jax.eval_shape(functools.partial(ref_init_params, cfg=cfg), jax.random.PRNGKey(0))
    return params, {b: jax.eval_shape(functools.partial(ref_init_cache, cfg, b, 64))
                    for b in (1, 8, 128)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_parameter_and_cache_spec_equals_reference(arch):
    ref_params, ref_caches = _ref_shapes(arch)
    flat = {"/".join(ref._path_names(path)): x
            for path, x in jax.tree_util.tree_flatten_with_path(ref_params)[0]}
    cfg = get_config(arch)
    model = DecoderLM(cfg, "meta")
    for mesh_name in MESHES:
        amesh, pmesh = _meshes(mesh_name)
        specs = port.param_specs(model, pmesh)
        assert set(specs) == set(dict(model.named_parameters()))
        for name, p in model.named_parameters():
            key, layer = _reference_key(name)
            x = flat[key]
            names = tuple(key.split("/"))
            want_rule = tuple(ref.param_spec_for(names, x.ndim, amesh))
            assert port.param_spec_for(names, x.ndim, pmesh) == want_rule, (name, mesh_name)
            want = tuple(ref.fit_spec(ref.param_spec_for(names, x.ndim, amesh), x.shape, amesh))
            if layer is not None:
                assert want[0] is None and tuple(x.shape[1:]) == tuple(p.shape)
                want = want[1:]
            else:
                assert tuple(x.shape) == tuple(p.shape)
            assert specs[name] == want, (name, mesh_name)
        for batch, ref_cache in ref_caches.items():
            cache = init_decode_cache(cfg, batch, 64, device="meta")
            assert set(cache) == set(ref_cache)
            for key, t in cache.items():
                assert tuple(t.shape) == tuple(ref_cache[key].shape)
                want = tuple(ref.fit_spec(ref.cache_spec(cfg, key, amesh, batch),
                                          ref_cache[key].shape, amesh))
                got = port.fit_spec(port.cache_spec(cfg, key, pmesh, batch), tuple(t.shape),
                                    pmesh)
                assert got == want, (key, batch, mesh_name)


def test_per_chip_bytes():
    mesh = port.MESHES["pod"]
    assert port.per_chip_bytes((4096, 1024), torch.bfloat16, ("data", "model"), mesh) == (
        256 * 64 * 2)
    assert port.per_chip_bytes((10, 7), torch.float32, (), mesh) == 280
    assert port.per_chip_bytes((64, 32, 16), torch.int32, (("pod", "data"), None, "model"),
                               port.MESHES["multipod"]) == 2 * 32 * 1 * 4


def test_card_specs_are_the_identity():
    cfg = get_config("deepseek-v2-236b")
    model = DecoderLM(cfg, "meta")
    for name, spec in port.param_specs(model, port.MESHES["card"]).items():
        assert spec == (None,) * model.get_parameter(name).dim(), name
