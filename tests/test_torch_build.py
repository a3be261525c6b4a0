"""The port's ctypes bindings against the C interfaces of `csrc/*.cu`.

The CUDA sources compile only on the card, so a binding that disagrees
with its source (a missing launcher, a wrong argument count) would show
there first; this reads the sources' `extern "C"` declarations here.
"""

import re

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402

_DECL = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)


def _exports() -> dict[str, int]:
    """{exported function: parameter count} over every csrc source."""
    out = {}
    for src in _build.CSRC.glob("*.cu"):
        for name, params in _DECL.findall(src.read_text()):
            out[name] = len([p for p in params.split(",") if p.strip()])
    return out


def test_every_export_is_bound():
    assert set(_exports()) == set(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_binding_argument_count_matches_source(name):
    assert _exports()[name] == len(_build.SIGNATURES[name])


def test_rerank_plan_array_matches_source(monkeypatch):
    """`rerank_launch` reads its plan from an int array: the fields of
    `struct Plan` in their order, then rv, qreg and smem."""
    import torch

    from repro_torch.kernels import rerank

    src = (_build.CSRC / "rerank.cu").read_text()
    struct = re.search(r"struct Plan \{\s*int ([^;]+);", src).group(1)
    fields = tuple(f.strip() for f in struct.split(","))
    tail = dict((name, int(i)) for name, i in re.findall(r"(\w+) = plan\[(\d+)\]", src))
    assert rerank.PLAN_FIELDS == fields + tuple(sorted(tail, key=tail.get))
    assert sorted(tail.values()) == list(range(len(fields), len(rerank.PLAN_FIELDS)))
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    plan = rerank.launch_plan(1000, 64, 128, 2, 132)
    arr = rerank._plan_array.__wrapped__(1000, 64, 128, 2, 0, torch.device("cpu"), 0)
    assert list(arr) == [int(plan[f]) for f in rerank.PLAN_FIELDS]
