"""Model assembly: init / teacher-forced forward / prefill / decode for every
architecture of ``repro_torch.configs``. Port of the JAX package's
``models/model.py``.

Layers are grouped by their offset inside the *effective period* P =
lcm(layer_period, moe.every): the layers at one offset share structure and
their params are stacked (n_super, ...), as the reference stacks them, so
weights carried over from the JAX package map key for key. The forward
pass loops over superblocks in Python where the reference runs
``lax.scan``. Under autograd each superblock is rematerialised as
``cfg.remat`` says (the reference's ``_remat``); serving runs under
``torch.inference_mode()``, where there is nothing to rematerialise.

Params are dicts of float32 tensors; compute runs in ``cfg.compute_dtype``.
Caches are tuples (one entry per offset) of dicts of tensors stacked
(n_super, ...), as the reference's.
"""
from __future__ import annotations

import math
from functools import partial

import torch

from repro_torch import resolve_device
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    apply_attention_decode,
    apply_attention_seq,
    apply_cross_attention_cached,
    apply_cross_attention_seq,
    apply_mlp,
    apply_norm,
    cdtype,
    cx,
    init_attention,
    init_mlp,
    init_norm,
    normal,
    sinusoid_positions,
    zeros,
)
from repro_torch.models.moe import apply_moe, init_moe

# ---------------------------------------------------------------------------
# structure helpers
# ---------------------------------------------------------------------------


def effective_period(cfg) -> int:
    p = cfg.layer_period
    if cfg.moe is not None:
        p = math.lcm(p, cfg.moe.every)
    return p


def n_superblocks(cfg) -> int:
    p = effective_period(cfg)
    if cfg.n_layers % p:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not a "
                         f"multiple of the period {p}")
    return cfg.n_layers // p


def _offset_kind(cfg, o):
    """('attn'|'ssm', 'moe'|'mlp'|None) for layer offset o."""
    mixer = "attn" if cfg.is_attn_layer(o) else "ssm"
    if cfg.arch_type == "ssm":
        ffn = None
    elif cfg.is_moe_layer(o):
        ffn = "moe"
    else:
        ffn = "mlp" if cfg.d_ff > 0 else None
    return mixer, ffn


def _unbind(tree):
    """A nested dict of stacked (n, ...) tensors -> the list of its n
    slices, one nested dict each. Each leaf is taken apart once
    (``torch.unbind``, whose backward is one ``stack``): indexing it slice
    by slice would, under autograd, allocate a zero gradient of the whole
    stacked leaf for every slice."""
    parts = {k: _unbind(v) if isinstance(v, dict) else torch.unbind(v, 0)
             for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _stack(trees):
    """Stack a list of nested dicts of tensors along a new leading axis."""
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


# ---------------------------------------------------------------------------
# sublayer init / apply
# ---------------------------------------------------------------------------


def init_sublayer(gen, cfg, o, device, with_xattn=False, lead=()):
    mixer, ffn = _offset_kind(cfg, o)
    p = {}
    if cfg.parallel_block:
        p["norm"] = init_norm(cfg, cfg.d_model, device, lead)
    else:
        p["norm1"] = init_norm(cfg, cfg.d_model, device, lead)
        if ffn is not None:
            p["norm2"] = init_norm(cfg, cfg.d_model, device, lead)
    if mixer == "attn":
        p["attn"] = init_attention(gen, cfg, device, lead=lead)
    else:
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, device, lead)
    if with_xattn:
        p["norm_x"] = init_norm(cfg, cfg.d_model, device, lead)
        p["xattn"] = init_attention(gen, cfg, device, cross=True, lead=lead)
    if ffn == "moe":
        p["moe"] = init_moe(gen, cfg, cfg.d_model, device, lead)
    elif ffn == "mlp":
        p["mlp"] = init_mlp(gen, cfg, cfg.d_model, cfg.d_ff, device, lead)
    return p


def apply_sublayer_seq(p, h, cfg, positions, o, enc_out=None, ssm_state=None):
    """Full-sequence pass. Returns (h, aux_loss, cache_entry)."""
    mixer, ffn = _offset_kind(cfg, o)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.parallel_block:
        hn = apply_norm(p["norm"], h, cfg)
        attn_out, (k, v) = apply_attention_seq(p["attn"], hn, cfg, positions)
        mlp_out = apply_mlp(p["mlp"], hn, cfg)
        return h + attn_out + mlp_out, aux, {"k": k, "v": v}

    hn = apply_norm(p["norm1"], h, cfg)
    if mixer == "attn":
        out, (k, v) = apply_attention_seq(p["attn"], hn, cfg, positions)
        cache_entry = {"k": k, "v": v}
    else:
        out, (conv_tail, final_state) = ssm_mod.apply_ssm_seq(
            p["ssm"], hn, cfg, ssm_state)
        cache_entry = {"conv": conv_tail, "ssm": final_state}
    h = h + out
    if "xattn" in p:
        hn = apply_norm(p["norm_x"], h, cfg)
        out, (xk, xv) = apply_cross_attention_seq(p["xattn"], hn, enc_out,
                                                  cfg)
        cache_entry["xk"], cache_entry["xv"] = xk, xv
        h = h + out
    if ffn == "moe":
        hn = apply_norm(p["norm2"], h, cfg)
        out, aux = apply_moe(p["moe"], hn, cfg)
        h = h + out
    elif ffn == "mlp":
        hn = apply_norm(p["norm2"], h, cfg)
        h = h + apply_mlp(p["mlp"], hn, cfg)
    return h, aux, cache_entry


def apply_sublayer_decode(p, h, cfg, cache_o, pos, o):
    """One-token decode. Returns h; the layer's cache ``cache_o`` is
    written in place (see :func:`decode_step`)."""
    mixer, ffn = _offset_kind(cfg, o)
    if cfg.parallel_block:
        hn = apply_norm(p["norm"], h, cfg)
        attn_out, _, _ = apply_attention_decode(
            p["attn"], hn, cfg, cache_o["k"], cache_o["v"], pos)
        mlp_out = apply_mlp(p["mlp"], hn, cfg)
        return h + attn_out + mlp_out

    hn = apply_norm(p["norm1"], h, cfg)
    if mixer == "attn":
        out, _, _ = apply_attention_decode(
            p["attn"], hn, cfg, cache_o["k"], cache_o["v"], pos)
    else:
        out, st = ssm_mod.apply_ssm_decode(
            p["ssm"], hn, cfg, {"conv": cache_o["conv"], "ssm": cache_o["ssm"]})
        cache_o["conv"].copy_(st["conv"])
        cache_o["ssm"].copy_(st["ssm"])
    h = h + out
    if "xattn" in p:
        hn = apply_norm(p["norm_x"], h, cfg)
        h = h + apply_cross_attention_cached(
            p["xattn"], hn, cache_o["xk"], cache_o["xv"], cfg)
    if ffn == "moe":
        hn = apply_norm(p["norm2"], h, cfg)
        out, _ = apply_moe(p["moe"], hn, cfg)
        h = h + out
    elif ffn == "mlp":
        hn = apply_norm(p["norm2"], h, cfg)
        h = h + apply_mlp(p["mlp"], hn, cfg)
    return h


# ---------------------------------------------------------------------------
# whole-model init
# ---------------------------------------------------------------------------


def init_params(cfg, generator, device="cuda"):
    """Random float32 params of ``cfg`` on ``device``, drawn from
    ``generator`` (on any device) with the reference's distributions and
    scales. Same tree as the reference's ``init_params``: per-offset layer
    params stacked (n_super, ...), in the tuple ``layers``."""
    device = resolve_device(device)
    gen = generator
    P = effective_period(cfg)
    ns = n_superblocks(cfg)
    with_x = cfg.encoder is not None
    params = {
        "layers": tuple(init_sublayer(gen, cfg, o, device, with_xattn=with_x,
                                      lead=(ns,)) for o in range(P)),
        "tok_embed": normal(gen, (cfg.vocab, cfg.d_model), 0.02, device),
        "final_norm": init_norm(cfg, cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = normal(gen, (cfg.d_model, cfg.vocab),
                                   cfg.d_model ** -0.5, device)
    if cfg.encoder is not None:
        params["encoder"] = {
            "layers": init_sublayer(gen, cfg, 0, device, with_xattn=False,
                                    lead=(cfg.encoder.n_layers,)),
            "final_norm": init_norm(cfg, cfg.d_model, device),
        }
    if cfg.vision is not None:
        params["vision_proj"] = {
            "w": normal(gen, (cfg.vision.d_vision, cfg.d_model),
                        cfg.vision.d_vision ** -0.5, device),
            "b": zeros((cfg.d_model,), device),
        }
    return params


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------


#: ops whose outputs the "dots" policy saves: matrix products without batch
#: dimensions (``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg):
    """``fn`` rematerialised in the backward pass as ``cfg.remat`` says:
    "full" saves only its inputs, "dots" also the outputs of its matrix
    products, "none" everything. Rematerialisation never changes a value;
    without autograd there is nothing to save and ``fn`` runs as is."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {"use_reentrant": False}
    if cfg.remat == "dots":
        kw["context_fn"] = partial(create_selective_checkpoint_contexts,
                                   _dots_policy)
    return lambda *args: checkpoint(fn, *args, **kw)


def apply_stack_seq(params, cfg, h, positions, enc_out=None,
                    with_cache=True):
    """Loop over superblocks. Returns (h, aux_total, cache tuple-of-dicts
    stacked (n_super, ...), or None without ``with_cache``)."""
    P = effective_period(cfg)

    def body(hh, aux, layer_ps):
        entries = []
        for o in range(P):
            hh, a, ce = apply_sublayer_seq(layer_ps[o], hh, cfg, positions,
                                           o, enc_out=enc_out)
            aux = aux + a
            entries.append(ce)
        return hh, aux, tuple(entries)

    body = _remat(body, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    layers = [_unbind(lp) for lp in params["layers"]]
    entries = [[] for _ in range(P)]
    for s in range(n_superblocks(cfg)):
        h, aux, ces = body(h, aux, tuple(lp[s] for lp in layers))
        if with_cache:
            for o in range(P):
                entries[o].append(ces[o])
    if not with_cache:
        return h, aux, None
    return h, aux, tuple(_stack(e) for e in entries)


def apply_stack_decode(params, cfg, h, cache, pos):
    """Returns (h, cache): each layer writes its slice of the stacked
    ``cache`` in place, and the same cache comes back."""
    P = effective_period(cfg)
    layers = [_unbind(lp) for lp in params["layers"]]
    caches = [_unbind(c) for c in cache]
    for s in range(n_superblocks(cfg)):
        for o in range(P):
            h = apply_sublayer_decode(layers[o][s], h, cfg, caches[o][s],
                                      pos, o)
    return h, cache


def apply_encoder(params, cfg, frames):
    """Whisper-style encoder over stubbed frame embeddings (B, T, D)."""
    h = frames.to(cdtype(cfg))
    h = h + sinusoid_positions(frames.shape[1], cfg.d_model,
                               frames.device).to(h.dtype)

    def body(hh, lp):
        hn = apply_norm(lp["norm1"], hh, cfg)
        out, _ = apply_attention_seq(lp["attn"], hn, cfg, positions=None,
                                     causal=False)
        hh = hh + out
        hn = apply_norm(lp["norm2"], hh, cfg)
        return hh + apply_mlp(lp["mlp"], hn, cfg)

    body = _remat(body, cfg)
    for lp in _unbind(params["encoder"]["layers"]):
        h = body(h, lp)
    return apply_norm(params["encoder"]["final_norm"], h, cfg)


# ---------------------------------------------------------------------------
# embeddings & logits
# ---------------------------------------------------------------------------


def embed_inputs(params, cfg, batch, positions):
    tokens = batch["tokens"]
    h = params["tok_embed"][tokens].to(cdtype(cfg))
    if cfg.vision is not None and "patches" in batch:
        vp = params["vision_proj"]
        img = batch["patches"].to(cdtype(cfg)) @ cx(vp["w"], cfg) \
            + cx(vp["b"], cfg)
        n = cfg.vision.n_img_tokens
        h = torch.cat([img[:, :n, :], h[:, n:, :]], dim=1)
    if cfg.encoder is not None:  # whisper decoder: sinusoid abs positions
        h = h + sinusoid_positions(h.shape[1], cfg.d_model,
                                   h.device).to(h.dtype)
    return h


# vocab columns of one lm-head product where the logits are smaller than
# the table: a multiple of 16, so that a vocab split over 16 model ranks
# splits each chunk evenly
LOGITS_CHUNK = 8192


def logits_from_h(params, cfg, h):
    """Float32 logits: compute-dtype operands, float32 products and sums
    (the reference's ``preferred_element_type=float32``). Where no
    gradient is taken and fewer rows than ``d_model`` meet the table (a
    decode step, a prefill's last position), the product runs over
    ``LOGITS_CHUNK`` columns of the vocab at a time: one chunk's
    compute-dtype and float32 copies of the table are live at once,
    where the whole table's two copies were (41.7% of mamba2-1.3b's
    ``long_500k`` peak a rank; XLA fuses both casts into the dot). Each
    output column is the same dot over the same operands. Under autograd
    each product's float32 operand is saved for the backward, so the
    product stays whole."""
    h = apply_norm(params["final_norm"], h, cfg).to(torch.float32)
    tied = cfg.tie_embeddings
    table = params["tok_embed"] if tied else params["unembed"]

    def head(w):
        w = cx(w, cfg).T if tied else cx(w, cfg)
        return torch.einsum("bsd,dv->bsv", h, w.to(torch.float32))
    vocab = table.shape[0 if tied else 1]
    if torch.is_grad_enabled() or vocab <= LOGITS_CHUNK \
            or h.shape[0] * h.shape[1] >= h.shape[2]:
        return head(table)
    return torch.cat([
        head(table[lo:lo + LOGITS_CHUNK] if tied
             else table[:, lo:lo + LOGITS_CHUNK])
        for lo in range(0, vocab, LOGITS_CHUNK)], dim=-1)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def _positions(tokens):
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device)[None, :].expand(b, s)


def apply_train(params, cfg, batch):
    """Teacher-forced full-sequence forward. Returns (logits f32, aux)."""
    positions = _positions(batch["tokens"])
    h = embed_inputs(params, cfg, batch, positions)
    enc_out = None
    if cfg.encoder is not None:
        enc_out = apply_encoder(params, cfg, batch["frames"])
    h, aux, _ = apply_stack_seq(params, cfg, h, positions, enc_out,
                                with_cache=False)
    return logits_from_h(params, cfg, h), aux


def prefill(params, cfg, batch):
    """Forward + cache build. Returns (last-token logits (B,1,V), cache)."""
    positions = _positions(batch["tokens"])
    h = embed_inputs(params, cfg, batch, positions)
    enc_out = None
    if cfg.encoder is not None:
        enc_out = apply_encoder(params, cfg, batch["frames"])
    h, _, cache = apply_stack_seq(params, cfg, h, positions, enc_out)
    return logits_from_h(params, cfg, h[:, -1:, :]), cache


def decode_step(params, cfg, cache, tokens, pos):
    """tokens (B,1) integer; pos (B,) integer. Returns (logits (B,1,V),
    cache). The cache is consumed, as the reference's decode step donates
    it (``donate_argnums``): every layer's new entries are written into it
    in place and the same tensors come back, so the step never holds a
    second cache. A caller that needs the old cache clones it first."""
    h = params["tok_embed"][tokens].to(cdtype(cfg))
    if cfg.encoder is not None:
        d = cfg.d_model
        div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                     device=h.device)
                        * (-math.log(10000.0) / d))
        ang = pos[:, None].to(torch.float32) * div
        # interleave to match sinusoid_positions layout
        pe = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(
            pos.shape[0], d)
        h = h + pe[:, None, :].to(h.dtype)
    h, new_cache = apply_stack_decode(params, cfg, h, cache, pos)
    return logits_from_h(params, cfg, h), new_cache


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------


def cache_seq_len(cfg, seq_len):
    """KV rows actually resident: sliding-window archs keep a ring buffer."""
    if cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_cache(cfg, batch, seq_len, device="cuda", dtype=None):
    """Zeroed decode cache matching apply_stack_decode's expectations."""
    device = resolve_device(device)
    dtype = dtype or cdtype(cfg)
    P = effective_period(cfg)
    ns = n_superblocks(cfg)
    hd = cfg.hd()
    s_res = cache_seq_len(cfg, seq_len)

    def z(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)
    entries = []
    for o in range(P):
        mixer, _ = _offset_kind(cfg, o)
        e = {}
        if mixer == "attn" or cfg.parallel_block:
            e["k"] = z((ns, batch, s_res, cfg.n_kv_heads, hd))
            e["v"] = z((ns, batch, s_res, cfg.n_kv_heads, hd))
        else:
            s = cfg.ssm
            d_in = s.d_inner(cfg.d_model)
            h = s.n_heads(cfg.d_model)
            gn = s.n_groups * s.d_state
            e["conv"] = z((ns, batch, s.conv_width - 1, d_in + 2 * gn))
            e["ssm"] = z((ns, batch, h, s.head_dim, s.d_state),
                         torch.float32)
        if cfg.encoder is not None:
            e["xk"] = z((ns, batch, cfg.encoder.n_frames, cfg.n_kv_heads, hd))
            e["xv"] = z((ns, batch, cfg.encoder.n_frames, cfg.n_kv_heads, hd))
        entries.append(e)
    return tuple(entries)


def convert_prefill_cache(cfg, cache, prefill_len, target_len, dtype=None):
    """Repack a prefill-built cache for decode continuation.

    Full attention: pad the seq axis to ``target_len``. Sliding window: fold
    the last ``window`` positions into ring-buffer order (slot = pos %
    window). SSM entries (conv tail / state) already match decode layout.
    """
    dtype = dtype or cdtype(cfg)
    s_res = cache_seq_len(cfg, target_len)
    out = []
    for e in cache:
        ne = {}
        for name, arr in e.items():
            if name in ("k", "v"):
                if cfg.sliding_window and cfg.sliding_window < prefill_len:
                    slots = torch.arange(s_res, device=arr.device)
                    # floor-mod of non-negative numbers, as the reference's
                    srcpos = prefill_len - 1 - ((prefill_len - 1 - slots)
                                                % s_res)
                    arr = arr.index_select(2, srcpos)
                elif arr.shape[2] < s_res:
                    pad = torch.zeros(
                        (*arr.shape[:2], s_res - arr.shape[2],
                         *arr.shape[3:]), dtype=arr.dtype, device=arr.device)
                    arr = torch.cat([arr, pad], dim=2)
                else:
                    arr = arr[:, :, :s_res]
                ne[name] = arr.to(dtype)
            elif name in ("xk", "xv"):
                ne[name] = arr.to(dtype)
            else:  # conv / ssm state
                ne[name] = arr
        out.append(ne)
    return tuple(out)


def abstract_params(cfg):
    """Shape/dtype tree of params on the ``meta`` device, without storage
    (for the sharding rules and the dry run)."""
    return init_params(cfg, torch.Generator(), device="meta")
