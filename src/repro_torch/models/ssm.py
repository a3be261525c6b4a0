"""Mamba2 SSD block (state-space duality, arXiv:2405.21060) + 1-step decode.

The port of `repro.models.ssm`.  Chunked SSD: within a chunk the
recurrence is a masked quadratic, attention-like product; across chunks a
(H, P, N) state is carried by a loop over the chunks.  Layer structure as
the Mamba2 reference: in_proj -> (z | x | B | C | dt) -> causal depthwise
conv1d on (x | B | C) -> SSD -> gated RMSNorm (z) -> out_proj.  The
reference runs no Pallas kernel here, so neither does the port: the
products are `torch.einsum`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Segment sums out[..., i, j] = sum_{j < t <= i} x[..., t] by
    differences of one cumulative sum, -inf above the diagonal (the masked
    decay matrix in log space)."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return torch.where(mask, d, -torch.inf)


def ssd_chunked(
    xh: torch.Tensor,      # (B, S, H, P) inputs per head
    dt: torch.Tensor,      # (B, S, H) softplus'd step sizes
    a_log: torch.Tensor,   # (H,) log A (negative decay)
    bmat: torch.Tensor,    # (B, S, H, N) input projections
    cmat: torch.Tensor,    # (B, S, H, N) output projections
    chunk: int,
    init_state: torch.Tensor | None = None,  # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked state-space duality scan, in f32.  Returns (y (B, S, H, P),
    final state (B, H, P, N))."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    nc = s // chunk

    a = -torch.exp(a_log.float())                               # (H,)
    da = dt.float() * a                                         # (B, S, H)
    dax = xh.float() * dt.float()[..., None]

    def ch(t):  # (B, nc, L, ...)
        return t.reshape(b, nc, chunk, *t.shape[2:])

    da_c, x_c = ch(da), ch(dax)
    b_c, c_c = ch(bmat.float()), ch(cmat.float())

    # intra-chunk (diagonal) term
    l_mat = torch.exp(_segsum(da_c.permute(0, 1, 3, 2)))        # (B, nc, H, L, L)
    scores = torch.einsum("bclhn,bcshn->bchls", c_c, b_c)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores * l_mat, x_c)

    # chunk states
    da_cum = torch.cumsum(da_c, dim=2)                          # (B, nc, L, H)
    da_tot = da_cum[:, :, -1, :]                                # (B, nc, H)
    decay_to_end = torch.exp(da_tot[:, :, None, :] - da_cum)
    states = torch.einsum("bclhn,bclh,bclhp->bchpn", b_c, decay_to_end, x_c)

    # inter-chunk recurrence: the state entering each chunk
    state = (init_state.float() if init_state is not None
             else torch.zeros((b, h, p, n), device=xh.device))
    prev = []
    for ci in range(nc):
        prev.append(state)
        state = states[:, ci] + torch.exp(da_tot[:, ci])[:, :, None, None] * state
    prev_states = torch.stack(prev, dim=1)                      # (B, nc, H, P, N)

    # inter-chunk (off-diagonal) output
    y_off = torch.einsum("bclhn,bclh,bchpn->bclhp", c_c, torch.exp(da_cum), prev_states)
    return (y_diag + y_off).reshape(b, s, h, p), state


def mamba2_block(
    x: torch.Tensor,              # (B, S, D)
    params,
    cfg,
    state: dict | None = None,    # decode: {"conv": (B, K-1, CD), "ssm": (B, H, P, N)}
) -> tuple[torch.Tensor, dict]:
    """A full Mamba2 layer.  `state` None: prefill / training over the
    sequence; given: the exact one-step decode recurrence (S == 1).
    Returns (out (B, S, D) in x's dtype, new state: the conv window in the
    activations' dtype and the f32 SSM state)."""
    b, s, d = x.shape
    di, h, p, n, k = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv
    conv_dim = di + 2 * h * n

    z, xbc, dt = torch.split(x @ params["in_proj"], [di, conv_dim, h], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])             # (B, S, H)

    # causal depthwise conv over (x | B | C)
    w = params["conv_w"]                                        # (K, conv_dim)
    if state is None:
        pad = xbc.new_zeros((b, k - 1, conv_dim))
    else:
        pad = state["conv"].to(xbc.dtype)
    xbc_p = torch.cat([pad, xbc], dim=1)
    new_conv = xbc_p[:, xbc_p.shape[1] - (k - 1):] if k > 1 else pad
    length = xbc_p.shape[1] - k + 1
    conv_out = sum(xbc_p[:, i : i + length] * w[i] for i in range(k))
    xbc = F.silu(conv_out)

    xh = xbc[..., :di].reshape(b, s, h, p)
    bmat = xbc[..., di : di + h * n].reshape(b, s, h, n)
    cmat = xbc[..., di + h * n :].reshape(b, s, h, n)

    if state is None:
        # pad S to a chunk multiple: dt = 0 padding leaves the carried state
        # as it is (decay exp(0) = 1, update 0) and its y is dropped
        chunk = min(cfg.ssm_chunk, max(s, 1))
        pad_s = (-s) % chunk
        if pad_s:
            xh, dt, bmat, cmat = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad_s))
                                  for t in (xh, dt, bmat, cmat))
        y, final = ssd_chunked(xh, dt, params["a_log"], bmat, cmat, chunk)
        y = y[:, :s]
    else:
        # exact one-step recurrence: s' = exp(dt a) s + dt x b^T; y = s' c
        a = -torch.exp(params["a_log"].float())
        da = dt[:, 0] * a                                       # (B, H)
        upd = torch.einsum("bhp,bhn->bhpn", xh[:, 0].float() * dt[:, 0, :, None],
                           bmat[:, 0].float())
        final = torch.exp(da)[:, :, None, None] * state["ssm"].float() + upd
        y = torch.einsum("bhpn,bhn->bhp", final, cmat[:, 0].float())[:, None]

    y = y.reshape(b, s, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["out_norm"])
    out = y @ params["out_proj"]
    return out.to(x.dtype), {"conv": new_conv, "ssm": final}
