"""Int8 gradient compression for the cross-pod data-parallel all-reduce.

The port of `repro.training.compression`.  A mesh axis becomes a leading
tensor axis here: `compressed_psum_pods` takes each leaf's per-pod
gradients stacked along a leading pod axis, quantizes each pod's to int8
with its own per-tensor scale, sums the int8 values in int32 and the
scales in f32, and dequantizes with the mean scale -- the value every pod
holds after the reference's `psum` over "pod".  No error-feedback residual
is kept (the reference's docstring promises one; its code keeps none).

One GPU has no pod axis, so the trainer's `grad_compress` is a no-op, as
the reference's is on a mesh without "pod".
"""

from __future__ import annotations

import torch


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, f32 scale): scale = max|g| / 127 (at least 1e-12 / 127),
    values round(g / scale) clipped to +-127 (half to even)."""
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum_pods(grads: dict) -> dict:
    """All-reduce mean over the leading pod axis of every leaf, in int8.

    `grads` maps names to (n_pods, ...) tensors; returns each leaf's
    reduced (...) f32 tensor."""

    def leaf_allreduce(g: torch.Tensor) -> torch.Tensor:
        npod = g.shape[0]
        qs, scales = zip(*(quantize(gp.float()) for gp in g))
        tot = torch.stack(qs).to(torch.int32).sum(0)
        s_all = torch.stack(scales).sum()
        return (tot.float() * (s_all / npod)) / npod

    return {name: leaf_allreduce(g) for name, g in grads.items()}
