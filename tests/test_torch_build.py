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
