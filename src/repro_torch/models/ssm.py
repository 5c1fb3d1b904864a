"""Mamba-2 (SSD, state-space duality) mixer as plain functions on dicts of
tensors. Port of the JAX package's ``models/ssm.py``.

Sequence mode uses the chunked SSD algorithm (arXiv:2405.21060 §6):
quadratic attention-like computation inside chunks, linear recurrence
across chunks. ``cfg.ssm_impl == "pallas"`` (the reference's name for the
kernel route) runs the intra-chunk stage in kernel K4
(``kernels/ops.py::ssd_chunked_kernel``); ``"jnp"`` runs ``ssd_chunked``,
the plain torch route. Decode mode is the O(1)-per-token recurrent update.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (cx, draw_device, gated_rmsnorm,
                                       normal, ones, zeros)

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_ssm(gen, cfg, device, lead=()):
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.d_inner(d)
    h = s.n_heads(d)
    gn = s.n_groups * s.d_state
    conv_ch = d_in + 2 * gn
    # dt bias init so softplus(dt_bias) spans [dt_min, dt_max]
    u = torch.rand((*lead, h), generator=gen,
                   device=draw_device(gen, device)).to(device)
    dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                   + math.log(s.dt_min))
    dt_bias = dt + torch.log(-torch.expm1(-dt))          # inverse softplus
    a_log = torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": normal(gen, (*lead, d, 2 * d_in + 2 * gn + h), d ** -0.5,
                          device),
        "conv_w": normal(gen, (*lead, s.conv_width, conv_ch),
                         s.conv_width ** -0.5, device),
        "conv_b": zeros((*lead, conv_ch), device),
        "A_log": a_log.expand(*lead, h).clone(),
        "D": ones((*lead, h), device),
        "dt_bias": dt_bias,
        "norm_scale": ones((*lead, d_in), device),
        "out_proj": normal(gen, (*lead, d_in, d), d_in ** -0.5, device),
    }


# ---------------------------------------------------------------------------
# chunked SSD (sequence mode)
# ---------------------------------------------------------------------------


def _segsum(x):
    """x (..., c) -> (..., c, c) with out[i, j] = sum_{j+1..i} x, -inf above
    the diagonal."""
    c = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    return torch.where(mask, seg, -math.inf)


def ssd_chunked(x, dt, A, B, C, chunk, init_state=None):
    """Chunked SSD, the plain route.

    x (b,l,h,p); dt (b,l,h) post-softplus; A (h,) negative; B,C (b,l,g,n).
    Returns (y (b,l,h,p), final_state (b,h,p,n)).
    """
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the "
                         f"chunk {chunk}")
    nc = l // chunk
    rep = h // g

    xr = x.reshape(b, nc, chunk, h, p)
    dtr = dt.reshape(b, nc, chunk, h)
    Br = B.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    Cr = C.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    dA = dtr * A                                        # (b,nc,c,h)
    dA_cs = torch.cumsum(dA, dim=2)

    # 1) intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(dA.transpose(-1, -2)))        # (b,nc,h,c,c)
    CB = torch.einsum("bzihn,bzjhn->bzhij", Cr, Br)
    y_diag = torch.einsum("bzhij,bzjh,bzjhp->bzihp", CB * L, dtr, xr)

    # 2) per-chunk output states
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)   # (b,nc,c,h)
    states = torch.einsum("bzchn,bzch,bzchp->bzhpn", Br, dtr * decay_states,
                          xr)

    # 3) inter-chunk recurrence (the reference's scan, a loop over chunks)
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])         # (b,nc,h)
    carry = (torch.zeros((b, h, p, n), dtype=states.dtype, device=x.device)
             if init_state is None else init_state)
    prev = []
    for z in range(nc):                                 # state BEFORE chunk
        prev.append(carry)
        carry = carry * chunk_decay[:, z, :, None, None] + states[:, z]
    prev_states = torch.stack(prev, dim=1)              # (b,nc,h,p,n)

    # 4) contribution of carried-in state to each position
    state_decay = torch.exp(dA_cs)                      # (b,nc,c,h)
    y_off = torch.einsum("bzchn,bzhpn,bzch->bzchp", Cr, prev_states,
                         state_decay)

    y = (y_diag + y_off).reshape(b, l, h, p)
    return y.to(x.dtype), carry


# ---------------------------------------------------------------------------
# full mamba2 block
# ---------------------------------------------------------------------------


def _split_proj(z_xbc_dt, cfg):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    gn = s.n_groups * s.d_state
    h = s.n_heads(cfg.d_model)
    z = z_xbc_dt[..., :d_in]
    xbc = z_xbc_dt[..., d_in:d_in + d_in + 2 * gn]
    dt = z_xbc_dt[..., -h:]
    return z, xbc, dt


def _conv_seq(p, xbc, cfg):
    """Causal depthwise conv over (B, L, CH)."""
    w = cx(p["conv_w"], cfg)                 # (W, CH)
    width = w.shape[0]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(width):                   # width is 4: unrolled taps
        out = out + pad[:, i:i + xbc.shape[1], :] * w[i]
    return F.silu(out + cx(p["conv_b"], cfg))


def apply_ssm_seq(p, x, cfg, init_state=None):
    """x (B, L, D) -> (out (B, L, D), (conv_tail, final_state))."""
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    h = s.n_heads(cfg.d_model)
    gn = s.n_groups * s.d_state
    bsz, l = x.shape[0], x.shape[1]
    proj = x @ cx(p["in_proj"], cfg)
    z, xbc, dt = _split_proj(proj, cfg)
    # for decode handoff; a copy, so that the cache does not keep the
    # whole of xbc alive through every later layer
    conv_tail = xbc[:, -(s.conv_width - 1):, :].clone()
    xbc = _conv_seq(p, xbc, cfg)
    xs = xbc[..., :d_in].reshape(bsz, l, h, s.head_dim)
    B = xbc[..., d_in:d_in + gn].reshape(bsz, l, s.n_groups, s.d_state)
    C = xbc[..., d_in + gn:].reshape(bsz, l, s.n_groups, s.d_state)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    f32 = torch.float32
    if getattr(cfg, "ssm_impl", "jnp") == "pallas":
        from repro_torch.kernels.ops import ssd_chunked_kernel
        y, final_state = ssd_chunked_kernel(
            xs.to(f32), dt, A, B.to(f32), C.to(f32), min(s.chunk, l),
            init_state)
    else:
        y, final_state = ssd_chunked(
            xs.to(f32), dt, A, B.to(f32), C.to(f32), min(s.chunk, l),
            init_state)
    y = y + xs.to(f32) * p["D"][:, None]
    y = y.reshape(bsz, l, d_in).to(x.dtype)
    y = gated_rmsnorm(p["norm_scale"], y, z, cfg.norm_eps)
    return y @ cx(p["out_proj"], cfg), (conv_tail, final_state)


def init_ssm_state(cfg, batch, device, dtype=torch.float32):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    h = s.n_heads(cfg.d_model)
    gn = s.n_groups * s.d_state
    conv_ch = d_in + 2 * gn
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, h, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }


def apply_ssm_decode(p, x, cfg, state):
    """One-token decode. x (B, 1, D); state dict -> (out (B,1,D), new state)."""
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    h = s.n_heads(cfg.d_model)
    gn = s.n_groups * s.d_state
    f32 = torch.float32
    proj = x[:, 0] @ cx(p["in_proj"], cfg)               # (B, .)
    z, xbc, dt = _split_proj(proj, cfg)

    # depthwise conv over rolling window
    conv_prev = state["conv"].to(xbc.dtype)              # (B, W-1, CH)
    window = torch.cat([conv_prev, xbc[:, None, :]], dim=1)   # (B, W, CH)
    w = cx(p["conv_w"], cfg)
    xbc_c = F.silu(torch.einsum("bwc,wc->bc", window, w)
                   + cx(p["conv_b"], cfg))
    new_conv = window[:, 1:, :].to(state["conv"].dtype)

    xs = xbc_c[..., :d_in].reshape(-1, h, s.head_dim).to(f32)
    B = xbc_c[..., d_in:d_in + gn].reshape(-1, s.n_groups, s.d_state)
    C = xbc_c[..., d_in + gn:].reshape(-1, s.n_groups, s.d_state)
    rep = h // s.n_groups
    Bh = B.repeat_interleave(rep, dim=1).to(f32)         # (B, h, n)
    Ch = C.repeat_interleave(rep, dim=1).to(f32)

    dt = F.softplus(dt.to(f32) + p["dt_bias"])           # (B, h)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)                               # (B, h)
    st = state["ssm"]                                    # (B, h, p, n)
    st = st * dA[..., None, None] + torch.einsum("bh,bhn,bhp->bhpn", dt, Bh,
                                                 xs)
    y = torch.einsum("bhpn,bhn->bhp", st, Ch) + xs * p["D"][:, None]
    y = y.reshape(-1, d_in).to(x.dtype)
    y = gated_rmsnorm(p["norm_scale"], y, z, cfg.norm_eps)
    out = (y @ cx(p["out_proj"], cfg))[:, None, :]
    return out, {"conv": new_conv, "ssm": st}
