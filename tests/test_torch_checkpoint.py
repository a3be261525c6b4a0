"""The port's checkpoints (ROADMAP A10): twins of tests/test_checkpoint.py,
the two checkpoint-crash tests of tests/test_faults.py, and checkpoints
crossing packages.

`repro_torch.checkpoint` writes the reference's on-disk format.  A port
round trip answers bit for bit; a port `save_engine` directory loads in
`repro.checkpoint.load_engine` and a reference one in the port's, with and
without a live delta, and both serve the same answers (ids equal,
distances allclose(rtol = atol = 1e-5), the parity contract's).
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import checkpoint as rckpt  # noqa: E402
from repro.retrieval import MemANNSEngine as RefEngine  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    load_engine,
    load_index,
    load_raw_store,
    save_engine,
    save_index,
)
from repro_torch.core.delta import DeltaIndex, compact_index  # noqa: E402
from repro_torch.core.index import build_index  # noqa: E402
from repro_torch.retrieval import MemANNSEngine  # noqa: E402
from repro_torch.retrieval.faults import FaultPlan, InjectedCrash  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


# the tiny shapes here are op overhead: with several test workers on the
# machine, torch's intra-op threads only contend (about 35x slower)
@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data():
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 5, (8, 16)).astype(np.float32)
    xs = centers[rng.integers(0, 8, 500)] + rng.normal(0, 1, (500, 16)).astype(np.float32)
    return xs, centers


@pytest.fixture(scope="module")
def small_index():
    xs, centers = _data()
    index = build_index(xs, 8, 4, kmeans_iters=4, pq_iters=3,
                        generator=torch.Generator().manual_seed(0), device="cpu")
    return index, xs, centers


def _new_rows(centers, seed, n=30, first=500):
    rng = np.random.default_rng(seed)
    ids = np.arange(first, first + n, dtype=np.int32)
    return ids, (centers[rng.integers(0, 8, n)]
                 + rng.normal(0, 1, (n, 16)).astype(np.float32))


def test_index_roundtrip(tmp_path, small_index):
    index, _, _ = small_index
    path = save_index(str(tmp_path / "ckpt"), index, extra={"block_n": 256})
    got, delta, extra = load_index(path)
    assert delta is None and extra == {"block_n": 256}
    for f in ("centroids", "codebook", "codes", "vec_ids", "offsets"):
        np.testing.assert_array_equal(getattr(got, f), getattr(index, f))


def test_index_delta_roundtrip(tmp_path, small_index):
    """Mid-churn state survives: buffered inserts, dead rows, tombstones."""
    index, _, centers = small_index
    delta = DeltaIndex.create(index.m, 64)
    new_ids, new_xs = _new_rows(centers, 1)
    delta.insert(index.centroids, index.codebook, new_ids, new_xs, device="cpu")
    delta.delete(np.asarray([3, 7, 505]))
    path = save_index(str(tmp_path / "ckpt"), index, delta=delta,
                      extra={"scan": "tiles", "nprobe": 8})
    got, got_delta, extra = load_index(path)
    assert extra == {"scan": "tiles", "nprobe": 8}
    assert got_delta is not None and got_delta.n == delta.n
    assert got_delta.capacity == delta.capacity and got_delta.tombstones == {3, 7, 505}
    for f in ("codes", "assign", "vec_ids", "dead", "vectors"):
        np.testing.assert_array_equal(getattr(got_delta, f), getattr(delta, f))
    np.testing.assert_array_equal(got_delta.live_mask(), delta.live_mask())
    a, _ = compact_index(index, delta)
    b, _ = compact_index(got, got_delta)
    for f in ("codes", "vec_ids", "offsets"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_save_overwrites_atomically(tmp_path, small_index):
    index, _, _ = small_index
    path = str(tmp_path / "ckpt")
    save_index(path, index, extra={"v": 1})
    save_index(path, index, extra={"v": 2})
    assert load_index(path)[2] == {"v": 2}
    assert not (tmp_path / "ckpt.tmp").exists() and not (tmp_path / "ckpt.old").exists()


def test_load_falls_back_to_old_after_crash(tmp_path, small_index):
    """A crash between the two renames leaves only `path.old`: it loads."""
    index, _, _ = small_index
    path = str(tmp_path / "ckpt")
    save_index(path, index, extra={"v": 1})
    os.rename(path, path + ".old")
    assert load_index(path)[2] == {"v": 1}
    save_index(path, index, extra={"v": 2})
    assert not (tmp_path / "ckpt.old").exists()
    assert load_index(path)[2] == {"v": 2}


def _unified(xs, centers, use_cooc, seed=2):
    eng = MemANNSEngine.build(xs, 8, 4, use_cooc=use_cooc, n_combos=16, block_n=256,
                              kmeans_iters=4, pq_iters=3, mutable=True, delta_capacity=64,
                              rerank="exact", k_overfetch=32, device="cpu")
    new_ids, new_xs = _new_rows(centers, seed)
    eng.insert(new_ids, new_xs)
    eng.delete(np.asarray([3, 7, 505]))
    rng = np.random.default_rng(seed + 1)
    qs = centers[rng.integers(0, 8, 6)] + rng.normal(0, 1, (6, 16)).astype(np.float32)
    return eng, qs


@pytest.mark.parametrize("use_cooc", [False, True])
def test_engine_roundtrip_unified_state(tmp_path, small_index, use_cooc):
    """Co-occurrence shards + live delta (inserts and tombstones) + raw
    store checkpoint as one unit; the restored engine (placement
    re-derived) answers bit for bit, and keeps compacting identically."""
    _, xs, centers = small_index
    eng, qs = _unified(xs, centers, use_cooc)
    d0, i0 = eng.search(qs, nprobe=4, k=5)
    got = load_engine(save_engine(str(tmp_path / "eng"), eng), device="cpu")
    assert (got.shards.n_combos > 0) == use_cooc
    assert got.delta is not None and got.delta.n == eng.delta.n
    assert got.delta.tombstones == eng.delta.tombstones
    assert got.raw is not None and got.raw.cap_slack == 0.5
    assert (got.scan, got.prune, got.rerank, got.k_overfetch) == (
        eng.scan, eng.prune, eng.rerank, eng.k_overfetch)
    d1, i1 = got.search(qs, nprobe=4, k=5)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(d0, d1)
    eng.compact()
    got.compact()
    d2, i2 = eng.search(qs, nprobe=4, k=5)
    d3, i3 = got.search(qs, nprobe=4, k=5)
    np.testing.assert_array_equal(i2, i3)
    np.testing.assert_array_equal(d2, d3)


def test_load_engine_rejects_plain_index_checkpoint(tmp_path, small_index):
    index, _, _ = small_index
    path = save_index(str(tmp_path / "ckpt"), index)
    with pytest.raises(ValueError, match="engine config"):
        load_engine(path, device="cpu")
    if not torch.cuda.is_available():  # the entry point defaults to cuda
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_engine(save_engine(str(tmp_path / "eng"), MemANNSEngine.from_reference(
                index, _placement(index), device="cpu")))


def _placement(index):
    from repro_torch.core.placement import place_clusters

    return place_clusters(index.cluster_sizes().astype(np.float64),
                          np.ones(index.n_clusters) / index.n_clusters, 2)


def test_load_validates(tmp_path, small_index):
    index, _, _ = small_index
    path = save_index(str(tmp_path / "ckpt"), index)
    ids = np.load(tmp_path / "ckpt" / "index" / "vec_ids.npy")
    ids[:] = 0
    np.save(tmp_path / "ckpt" / "index" / "vec_ids.npy", ids)
    with pytest.raises(ValueError, match="duplicate"):
        load_index(path)


# --------------------------- checkpoint crash -------------------------- #


@pytest.mark.parametrize("point", ["before_commit", "after_rename_old", "after_rename_new"])
def test_save_crash_at_every_point_still_restores(tmp_path, small_index, point):
    """Twin of tests/test_faults.py's: crash the save at each point of the
    rename choreography; load returns the complete old or new checkpoint,
    and the next save heals the debris."""
    index, _, _ = small_index
    path = str(tmp_path / "ckpt")
    save_index(path, index, extra={"v": 1})
    fp = FaultPlan(crash_save_at=point)
    with pytest.raises(InjectedCrash):
        save_index(path, index, extra={"v": 2}, faults=fp)
    assert fp.events == [("crash_save", {"point": point})]
    got, _, extra = load_index(path)
    assert extra["v"] in (1, 2)
    if point == "before_commit":
        assert extra["v"] == 1
    if point == "after_rename_new":
        assert extra["v"] == 2
    np.testing.assert_array_equal(got.codes, index.codes)
    save_index(path, index, extra={"v": 2}, faults=fp)
    assert load_index(path)[2] == {"v": 2}
    assert not (tmp_path / "ckpt.tmp").exists() and not (tmp_path / "ckpt.old").exists()


def test_save_after_crash_keeps_the_old_checkpoint(tmp_path, small_index, monkeypatch):
    """After a crash between the renames `path.old` is the only complete
    checkpoint; the next save keeps it until the new one is in place, so a
    failure of that save's final rename still loads it (ROADMAP C8: the
    reference deletes it first)."""
    from repro_torch.checkpoint import store

    index, _, _ = small_index
    path = str(tmp_path / "ckpt")
    save_index(path, index, extra={"v": 1})
    with pytest.raises(InjectedCrash):
        save_index(path, index, extra={"v": 2}, faults=FaultPlan(crash_save_at="after_rename_old"))
    rename = os.rename

    def failing(src, dst):
        if str(src).endswith(".tmp"):
            raise OSError("the disk went away")
        return rename(src, dst)

    monkeypatch.setattr(store.os, "rename", failing)
    with pytest.raises(OSError, match="went away"):
        save_index(path, index, extra={"v": 3})
    monkeypatch.undo()
    assert load_index(path)[2] == {"v": 1}
    save_index(path, index, extra={"v": 4})
    assert load_index(path)[2] == {"v": 4} and not (tmp_path / "ckpt.old").exists()


def test_corrupt_checkpoint_fails_with_clear_error(tmp_path, small_index):
    """Twin of tests/test_faults.py's: a garbage array or a truncated
    meta.json raises a ValueError naming the path, never serves rows."""
    index, _, _ = small_index
    path = str(tmp_path / "ckpt")
    save_index(path, index, extra={"v": 1})
    (tmp_path / "ckpt" / "index" / "codes.npy").write_bytes(b"not a numpy file at all")
    with pytest.raises(ValueError, match="corrupt or unreadable"):
        load_index(path)
    save_index(path, index, extra={"v": 1})
    (tmp_path / "ckpt" / "meta.json").write_text("{truncated")
    with pytest.raises(ValueError, match="corrupt or unreadable"):
        load_index(path)


# ------------------------------ rotation -------------------------------- #


def test_rotation_and_bf16_store_roundtrip(tmp_path, small_index):
    """An OPQ engine's rotation and a bf16 raw store (written up-cast to
    f32, `raw_dtype` bfloat16) come back bit for bit, and the restored
    engine answers as the saved one."""
    _, xs, centers = small_index
    eng = MemANNSEngine.build(xs, 8, 4, block_n=256, kmeans_iters=4, pq_iters=3,
                              opq_iters=2, rerank="exact", raw_dtype="bfloat16",
                              k_overfetch=32, device="cpu")
    path = save_engine(str(tmp_path / "eng"), eng)
    raw = np.load(tmp_path / "eng" / "raw" / "vectors.npy")
    assert raw.dtype == np.float32 and raw.shape[0] == eng.ndev
    got = load_engine(path, device="cpu")
    np.testing.assert_array_equal(got.index.rotation, eng.index.rotation)
    assert got.raw.dtype == "bfloat16" and got.raw.vectors.dtype == torch.bfloat16
    for d in range(eng.ndev):
        assert torch.equal(got.raw.device_rows(d), eng.raw.device_rows(d))
    qs = xs[:6] + 0.1
    for a, b in zip(got.search(qs, 4, 5), eng.search(qs, 4, 5)):
        np.testing.assert_array_equal(a, b)
    assert load_raw_store(save_index(str(tmp_path / "idx"), eng.index), "cpu") is None


# ---------------------------- across packages --------------------------- #


@pytest.fixture(scope="module")
def ref_engine():
    xs, _ = _data()
    return RefEngine.build(jax.random.PRNGKey(0), xs, 8, 4, block_n=256, kmeans_iters=4,
                           pq_iters=3, rerank="exact", k_overfetch=32, store_raw=True), xs


def _mutate(eng, centers):
    new_ids, new_xs = _new_rows(centers, 5)
    eng.insert(new_ids, new_xs)
    eng.delete(np.asarray([3, 7, 505, 11]))


def _queries(centers):
    rng = np.random.default_rng(9)
    return centers[rng.integers(0, 8, 8)] + rng.normal(0, 1, (8, 16)).astype(np.float32)


def _close(a, b):
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_allclose(a[0], b[0], **TOL)


@pytest.mark.parametrize("with_delta", [False, True])
def test_reference_engine_checkpoint_loads_in_port(tmp_path, ref_engine, with_delta):
    from repro.retrieval.mutation import ensure_delta

    ref0, xs = ref_engine
    _, centers = _data()
    ref = dataclasses.replace(ref0, delta=None, _dev_arrays=None, _raw_arrays=None)
    if with_delta:
        ensure_delta(ref, 64)
        _mutate(ref, centers)
    path = rckpt.save_engine(str(tmp_path / "ref"), ref)
    got = load_engine(path, device="cpu")
    assert (got.delta is not None) == with_delta
    qs = _queries(centers)
    _close(got.search(qs, 4, 5), ref.search(qs, 4, 5))
    for rerank in ("off", "exact"):
        a = dataclasses.replace(got, rerank=rerank).search(qs, 4, 5)
        _close(a, dataclasses.replace(ref, rerank=rerank).search(qs, 4, 5))


@pytest.mark.parametrize("with_delta", [False, True])
def test_port_engine_checkpoint_loads_in_reference(tmp_path, ref_engine, with_delta):
    ref0, xs = ref_engine
    _, centers = _data()
    port = MemANNSEngine.from_reference(ref0.index, ref0.placement, xs, block_n=256,
                                        rerank="exact", k_overfetch=32, raw_dtype="bfloat16",
                                        mutable=with_delta, delta_capacity=64, device="cpu")
    if with_delta:
        _mutate(port, centers)
    path = save_engine(str(tmp_path / "port"), port)
    got = rckpt.load_engine(path)
    assert (got.delta is not None) == with_delta and got.raw.dtype == "bfloat16"
    qs = _queries(centers)
    _close(got.search(qs, 4, 5), port.search(qs, 4, 5))
    # port -> port is bit for bit
    again = load_engine(path, device="cpu")
    for a, b in zip(again.search(qs, 4, 5), port.search(qs, 4, 5)):
        np.testing.assert_array_equal(a, b)
