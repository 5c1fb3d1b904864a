"""Shared layers of the LM stack as plain functions on dicts of tensors.

Port of the JAX package's ``models/layers.py``, with its conventions:
  * params are stored float32; compute runs in ``cfg.compute_dtype``
    (bfloat16 on the card; the CPU tests use float32);
  * attention weights keep the 4-D layouts ``(D, H, hd)`` / ``(H, hd, D)``,
    so weights carried over from the JAX package line up key for key.
Init functions take a ``torch.Generator`` and draw the reference's
distributions and scales (not its bits). ``lead`` is a prefix of the
shape, the stacked superblock axis that ``model.init_params`` adds.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
NEG_INF = -1e30

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def cdtype(cfg) -> torch.dtype:
    return _DTYPES[getattr(cfg, "compute_dtype", "bfloat16")]


def cx(x, cfg):
    """Cast a param/activation to the compute dtype."""
    return x.to(cdtype(cfg))


def draw_device(gen, device):
    """Where a draw for ``device`` runs: on the generator's device, so
    the card and the CPU see the same values; on ``meta`` for a meta
    ``device``, which holds shapes only."""
    return device if torch.device(device).type == "meta" else gen.device


def normal(gen, shape, scale, device):
    """float32 N(0, 1) * scale of ``shape``, drawn on the generator's device
    and moved to ``device``."""
    return (torch.randn(tuple(shape), generator=gen,
                        device=draw_device(gen, device)) * scale).to(device)


def ones(shape, device):
    return torch.ones(tuple(shape), dtype=torch.float32, device=device)


def zeros(shape, device):
    return torch.zeros(tuple(shape), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(cfg, d, device, lead=()):
    p = {"scale": ones((*lead, d), device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = zeros((*lead, d), device)
    return p


def apply_norm(p, x, cfg):
    x32 = x.to(torch.float32)
    if cfg.norm_type == "layernorm":
        mu = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, correction=0)
        y = (x32 - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = x32.square().mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(ms + cfg.norm_eps)
        y = y * p["scale"]
    return y.to(x.dtype)


def rms_head_norm(scale, x, eps):
    """qk-norm: rmsnorm over the last (head) dim with learned scale (hd,)."""
    x32 = x.to(torch.float32)
    ms = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * scale).to(x.dtype)


def gated_rmsnorm(scale, y, z, eps):
    """Mamba-2 output norm: rmsnorm(y * silu(z)) with learned scale."""
    y32 = (y * F.silu(z)).to(torch.float32)
    ms = y32.square().mean(-1, keepdim=True)
    return (y32 * torch.rsqrt(ms + eps) * scale).to(y.dtype)


# ---------------------------------------------------------------------------
# rotary / sinusoidal positions
# ---------------------------------------------------------------------------


def rope_freqs(hd, theta, device):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, positions, theta):
    """x: (..., S, n_heads, hd); positions: (..., S) integer. The head dim
    is split in halves (not interleaved)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)              # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                   # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoid_positions(seq, d, device, offset=0):
    pos = torch.arange(offset, offset + seq, dtype=torch.float32,
                       device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(gen, cfg, d, f, device, lead=()):
    p = {
        "wi": normal(gen, (*lead, d, f), d ** -0.5, device),
        "wo": normal(gen, (*lead, f, d), f ** -0.5, device),
    }
    if cfg.mlp_act == "swiglu":
        p["wg"] = normal(gen, (*lead, d, f), d ** -0.5, device)
    return p


def activate(h, cfg, gate=None):
    """The MLP nonlinearity; ``gate`` is x @ wg for swiglu."""
    if cfg.mlp_act == "swiglu":
        return F.silu(gate) * h
    if cfg.mlp_act == "gelu":
        return F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    if cfg.mlp_act == "squared_relu":
        return F.relu(h).square()
    raise ValueError(cfg.mlp_act)


def apply_mlp(p, x, cfg):
    h = x @ cx(p["wi"], cfg)
    gate = x @ cx(p["wg"], cfg) if cfg.mlp_act == "swiglu" else None
    return activate(h, cfg, gate) @ cx(p["wo"], cfg)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def init_attention(gen, cfg, device, cross=False, lead=()):
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    s = d ** -0.5
    p = {
        "wq": normal(gen, (*lead, d, h, hd), s, device),
        "wk": normal(gen, (*lead, d, k, hd), s, device),
        "wv": normal(gen, (*lead, d, k, hd), s, device),
        "wo": normal(gen, (*lead, h, hd, d), (h * hd) ** -0.5, device),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros((*lead, h, hd), device)
        p["bk"] = zeros((*lead, k, hd), device)
        p["bv"] = zeros((*lead, k, hd), device)
    if cfg.qk_norm and not cross:
        p["q_norm"] = ones((*lead, hd), device)
        p["k_norm"] = ones((*lead, hd), device)
    return p


def _qkv(p, xq, xkv, cfg, q_positions=None, kv_positions=None, rope=True):
    q = torch.einsum("bsd,dhk->bshk", xq, cx(p["wq"], cfg))
    k = torch.einsum("bsd,dhk->bshk", xkv, cx(p["wk"], cfg))
    v = torch.einsum("bsd,dhk->bshk", xkv, cx(p["wv"], cfg))
    if "bq" in p:
        q = q + cx(p["bq"], cfg)
        k = k + cx(p["bk"], cfg)
        v = v + cx(p["bv"], cfg)
    if "q_norm" in p:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    if rope and cfg.use_rope:
        q = apply_rope(q, q_positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def _gqa_scores_to_out(q, k, v, mask, cfg):
    """q (B,Q,H,hd); k,v (B,S,K,hd); mask (B?,Q,S) bool or None ->
    (B,Q,H,hd). Scores are float32 (the reference's
    ``preferred_element_type``): products of compute-dtype values, summed in
    float32."""
    b, ql, h, hd = q.shape
    kheads = k.shape[2]
    g = h // kheads
    qg = q.reshape(b, ql, kheads, g, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32))
    scores = scores * (hd ** -0.5)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        scores = torch.tanh(scores / c) * c
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(b, ql, h, hd)


def causal_mask(q_len, kv_len, device, q_offset=0, window=0):
    """(q_len, kv_len) bool; True = attend. Optional sliding window."""
    qpos = torch.arange(q_len, device=device)[:, None] + q_offset
    kpos = torch.arange(kv_len, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m = m & (kpos > qpos - window)
    return m


def math_gcd_chunk(s, chunk):
    g = math.gcd(s, chunk)
    return g if g > 1 else s


def _chunked_attention(q, k, v, cfg, win, chunk=512):
    """Blockwise causal attention, one q chunk at a time, so the score
    tensor is (B, heads, chunk, S) instead of (B, heads, S, S). With a
    sliding window the kv span is sliced to (win + chunk), so compute also
    scales with the window. Plain torch (the reference's ``lax.scan`` is a
    Python loop); kernel K5 is the fused counterpart."""
    b, s, h, hd = q.shape
    chunk = min(chunk, s)
    if s % chunk:
        chunk = math_gcd_chunk(s, chunk)
    span = s if not win else min(win + chunk, s)
    outs = []
    for q_start in range(0, s, chunk):
        qb = q[:, q_start:q_start + chunk]
        if win and span < s:
            kv_start = min(max(q_start + chunk - span, 0), s - span)
            kb = k[:, kv_start:kv_start + span]
            vb = v[:, kv_start:kv_start + span]
            kpos = kv_start + torch.arange(span, device=q.device)[None, :]
        else:
            kb, vb = k, v
            kpos = torch.arange(s, device=q.device)[None, :]
        qpos = q_start + torch.arange(chunk, device=q.device)[:, None]
        m = kpos[None] <= qpos[None]                     # (1,c,span)
        if win:
            m = m & (kpos[None] > qpos[None] - win)
        outs.append(_gqa_scores_to_out(qb, kb, vb, m, cfg))
    return torch.cat(outs, dim=1)


def apply_attention_seq(p, x, cfg, positions, window=None, causal=True):
    """Full-sequence (train/prefill) self attention. Returns (out, (k, v))."""
    q, k, v = _qkv(p, x, x, cfg, positions, positions)
    win = cfg.sliding_window if window is None else window
    if cfg.attn_impl == "flash" and causal:
        from repro_torch.kernels.ops import swa_flash_attention
        out = swa_flash_attention(q, k, v, window=win, causal=True)
    elif cfg.attn_impl == "chunked" and causal:
        out = _chunked_attention(q, k, v, cfg, win)
    else:
        m = (causal_mask(x.shape[1], x.shape[1], x.device, window=win)[None]
             if causal else None)
        out = _gqa_scores_to_out(q, k, v, m, cfg)
    out = torch.einsum("bqhk,hkd->bqd", out, cx(p["wo"], cfg))
    return out, (k, v)


def _slot_position(slot, pos, s):
    """Absolute position stored in ring slot `slot` when head is at `pos`
    (floor-mod, as the reference's ``%`` on negative numbers)."""
    cur_slot = pos % s
    delta = (cur_slot - slot) % s
    return pos - delta


def apply_attention_decode(p, x, cfg, k_cache, v_cache, pos, window=None):
    """One-token decode. x (B,1,D); caches (B,S,K,hd); pos (B,) integer.

    Caches are ring-buffers when ``window`` is set (position mod S);
    otherwise plain append at ``pos``. Returns (out, k_cache, v_cache).
    The caches are consumed: the new k, v are written into them in place
    and the same tensors come back, as the reference's decode step donates
    its cache (``donate_argnums``), so a step never holds an old and a new
    cache at once. A caller that needs the old cache clones it first.
    """
    b = x.shape[0]
    s = k_cache.shape[1]
    q, k, v = _qkv(p, x, x, cfg, pos[:, None], pos[:, None])
    slot = pos % s
    bidx = torch.arange(b, device=x.device)
    k_cache.index_put_((bidx, slot), k[:, 0].to(k_cache.dtype))
    v_cache.index_put_((bidx, slot), v[:, 0].to(v_cache.dtype))
    kpos = torch.arange(s, device=x.device)[None, :]
    win = cfg.sliding_window if window is None else window
    if win:
        # ring buffer: valid slots are the last `win` positions in [0, pos]
        slotpos = _slot_position(kpos, pos[:, None], s)
        age = pos[:, None] - slotpos
        valid = (slotpos >= 0) & (age < min(win, s))
    else:
        valid = kpos <= pos[:, None]
    m = valid[:, None, :]                                # (B,1,S)
    out = _gqa_scores_to_out(q, k_cache.to(q.dtype), v_cache.to(q.dtype), m,
                             cfg)
    out = torch.einsum("bqhk,hkd->bqd", out, cx(p["wo"], cfg))
    return out, k_cache, v_cache


def apply_cross_attention_seq(p, x, enc_out, cfg):
    q, k, v = _qkv(p, x, enc_out, cfg, rope=False)
    out = _gqa_scores_to_out(q, k, v, None, cfg)
    return torch.einsum("bqhk,hkd->bqd", out, cx(p["wo"], cfg)), (k, v)


def apply_cross_attention_cached(p, x, k_cache, v_cache, cfg):
    q = torch.einsum("bsd,dhk->bshk", x, cx(p["wq"], cfg))
    if "bq" in p:
        q = q + cx(p["bq"], cfg)
    out = _gqa_scores_to_out(q, k_cache.to(q.dtype), v_cache.to(q.dtype),
                             None, cfg)
    return torch.einsum("bqhk,hkd->bqd", out, cx(p["wo"], cfg))
