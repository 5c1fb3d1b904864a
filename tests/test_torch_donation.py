"""The port's donated buffers against the functional versions they replace,
bitwise, on the CPU.

The reference's decode step donates its cache and its train step its
state (``donate_argnums``): XLA writes the new values into the old
buffers. The port does the same by hand: ``apply_attention_decode`` and
``decode_step`` write the cache in place, ``adamw_update`` (and so
``train_step``) updates the params and moments in place, and the prefill
keeps a copy of each SSM layer's conv tail instead of a view of its whole
``xbc``. Each is the same arithmetic as before, op for op, with the
storage reused. The functional versions they replace are copied below
verbatim (as they stood before the change) and the in-place ones are held
to them with ``torch.equal``. The JAX package is not needed here: the
parity files (``test_torch_serve.py``, ``test_torch_train.py``,
``test_torch_lm_layers.py``) hold the port to it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import (_gqa_scores_to_out, _qkv,
                                       _slot_position, apply_attention_decode,
                                       apply_cross_attention_cached,
                                       apply_mlp, apply_norm, cx)
from repro_torch.models.moe import apply_moe
from repro_torch.optim import optimizers as O
from repro_torch.train import steps as ST

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the functional versions, as they were
# ---------------------------------------------------------------------------


def functional_adamw_update(cfg, params, grads, state):
    gnorm = O._global_norm(grads)
    scale = O._clip_scale(gnorm, cfg.grad_clip)
    step = state["step"] + 1
    lr = O._schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2

    stepf = step.to(torch.float32)
    newm = O.tree_map(
        lambda m, g: b1 * m + (1 - b1) * (g * scale).to(torch.float32),
        state["m"], grads)
    newv = O.tree_map(
        lambda v, g: b2 * v + (1 - b2) * (g * scale).to(torch.float32)
        .square(), state["v"], grads)
    c1, c2 = 1 - b1 ** stepf, 1 - b2 ** stepf

    def upd(p, m, v):
        mhat = m / c1
        vhat = v / c2
        newp = p - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                         + cfg.weight_decay * p)
        return newp.to(p.dtype)

    newp = O.tree_map(upd, params, newm, newv)
    return newp, {"m": newm, "v": newv, "step": step}, gnorm


def functional_attention_decode(p, x, cfg, k_cache, v_cache, pos,
                                window=None):
    b = x.shape[0]
    s = k_cache.shape[1]
    q, k, v = _qkv(p, x, x, cfg, pos[:, None], pos[:, None])
    slot = pos % s
    bidx = torch.arange(b, device=x.device)
    k_cache = k_cache.index_put((bidx, slot), k[:, 0].to(k_cache.dtype))
    v_cache = v_cache.index_put((bidx, slot), v[:, 0].to(v_cache.dtype))
    kpos = torch.arange(s, device=x.device)[None, :]
    win = cfg.sliding_window if window is None else window
    if win:
        slotpos = _slot_position(kpos, pos[:, None], s)
        age = pos[:, None] - slotpos
        valid = (slotpos >= 0) & (age < min(win, s))
    else:
        valid = kpos <= pos[:, None]
    m = valid[:, None, :]
    out = _gqa_scores_to_out(q, k_cache.to(q.dtype), v_cache.to(q.dtype), m,
                             cfg)
    out = torch.einsum("bqhk,hkd->bqd", out, cx(p["wo"], cfg))
    return out, k_cache, v_cache


def functional_sublayer_decode(p, h, cfg, cache_o, pos, o):
    mixer, ffn = M._offset_kind(cfg, o)
    nc = dict(cache_o)
    if cfg.parallel_block:
        hn = apply_norm(p["norm"], h, cfg)
        attn_out, nk, nv = functional_attention_decode(
            p["attn"], hn, cfg, cache_o["k"], cache_o["v"], pos)
        mlp_out = apply_mlp(p["mlp"], hn, cfg)
        nc["k"], nc["v"] = nk, nv
        return h + attn_out + mlp_out, nc

    hn = apply_norm(p["norm1"], h, cfg)
    if mixer == "attn":
        out, nk, nv = functional_attention_decode(
            p["attn"], hn, cfg, cache_o["k"], cache_o["v"], pos)
        nc["k"], nc["v"] = nk, nv
    else:
        out, st = SSM.apply_ssm_decode(
            p["ssm"], hn, cfg, {"conv": cache_o["conv"], "ssm": cache_o["ssm"]})
        nc["conv"], nc["ssm"] = st["conv"], st["ssm"]
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
    return h, nc


def functional_decode_step(params, cfg, cache, tokens, pos):
    """``decode_step`` with the functional stack (the encoder's position
    table is the same code as ``M.decode_step``'s)."""
    P = M.effective_period(cfg)
    h = params["tok_embed"][tokens].to(M.cdtype(cfg))
    if cfg.encoder is not None:
        d = cfg.d_model
        div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32)
                        * (-np.log(10000.0) / d))
        ang = pos[:, None].to(torch.float32) * div
        pe = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(
            pos.shape[0], d)
        h = h + pe[:, None, :].to(h.dtype)
    layers = [M._unbind(lp) for lp in params["layers"]]
    caches = [M._unbind(c) for c in cache]
    entries = [[] for _ in range(P)]
    for s in range(M.n_superblocks(cfg)):
        for o in range(P):
            h, nce = functional_sublayer_decode(layers[o][s], h, cfg,
                                                caches[o][s], pos, o)
            entries[o].append(nce)
    return (M.logits_from_h(params, cfg, h),
            tuple(M._stack(e) for e in entries))


def _clone(tree):
    return O.tree_map(torch.clone, tree)


def _equal(a, b):
    la, lb = O.tree_leaves(a), O.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _tree(rng, scale, bf16=False):
    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)).to(dtype)
    return {"a": t(7, 5), "b": (t(3), t(2, 4, 3)),
            "c": {"w": t(6, dtype=torch.bfloat16 if bf16 else torch.float32)}}


@pytest.mark.parametrize("grad_scale", [0.01, 3.0])
@pytest.mark.parametrize("bf16", [False, True])
def test_adamw_in_place_equals_functional(grad_scale, bf16):
    """Three steps (grad_scale 3 clips): params, moments, step and norm
    bitwise equal to the functional update's; the trees given are the
    trees returned, their storage reused (a bfloat16 leaf rounds as
    ``.to`` rounds)."""
    rng = np.random.default_rng(0)
    cfg = O.AdamWConfig(lr=1e-2, warmup_steps=4, weight_decay=0.1)
    params = _tree(rng, 1.0, bf16)
    state = O.adamw_init(params)
    fparams, fstate = _clone(params), _clone(state)
    for _ in range(3):
        grads = _tree(rng, grad_scale, bf16)
        ptrs = [t.data_ptr() for t in O.tree_leaves((params, state))]
        fparams, fstate, fnorm = functional_adamw_update(cfg, fparams, grads,
                                                         fstate)
        newp, news, norm = O.adamw_update(cfg, params, grads, state)
        assert newp is params and news is state
        assert [t.data_ptr() for t in O.tree_leaves((newp, news))] == ptrs
        assert torch.equal(norm, fnorm)
        assert _equal(newp, fparams) and _equal(news, fstate)
    assert int(state["step"]) == 3


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-1.3b",
                                  "mixtral-8x22b"])
def test_train_step_consumes_its_state(arch):
    """Two train steps: the metrics and the new state bitwise equal to the
    functional AdamW's on a clone of the same state; the state given is
    written in place (the reference donates it)."""
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype="float32")
    state = ST.init_train_state(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    want = _clone(state)
    opt = O.AdamWConfig(lr=1e-3, warmup_steps=2)
    step = ST.make_train_step(cfg, opt)
    rng = np.random.default_rng(3)
    for _ in range(2):
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))
        batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
        (loss, _), grads = ST.value_and_grad(want.params, cfg, batch)
        with torch.no_grad():
            wp, wo, wn = functional_adamw_update(opt, want.params, grads,
                                                 want.opt)
        want = ST.TrainState(wp, wo)
        ptrs = [t.data_ptr() for t in O.tree_leaves(state)]
        new, m = step(state, batch)
        assert [t.data_ptr() for t in O.tree_leaves(new)] == ptrs
        assert torch.equal(m["loss"], loss) and torch.equal(
            m["grad_norm"], wn)
        assert _equal(new, want)
        state = new


# ---------------------------------------------------------------------------
# the decode cache
# ---------------------------------------------------------------------------


def _cfg(arch):
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype="float32")
    if cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=6)
    return cfg


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_writes_its_cache_in_place(arch):
    """Prefill 20 tokens (phi-3's 16 image tokens among them), then 6
    decode steps (the 6-slot sliding window
    wraps): logits and every cache leaf bitwise equal to the functional
    step's on a copy of the cache, and the cache given is the cache
    returned, every leaf's storage reused."""
    cfg = _cfg(arch)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(1)
    b, pre, total = 2, 20, 26
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, total)))
    batch = {"tokens": tokens[:, :pre]}
    if cfg.vision is not None:
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.vision.n_img_tokens, cfg.vision.d_vision))
            .astype(np.float32))
    if cfg.encoder is not None:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32))
    with torch.inference_mode():
        _, pcache = M.prefill(params, cfg, batch)
        cache = M.convert_prefill_cache(cfg, pcache, pre, total)
        want = _clone(cache)
        for t in range(pre, total):
            pos = torch.full((b,), t)
            tok = tokens[:, t:t + 1]
            wl, want = functional_decode_step(params, cfg, want, tok, pos)
            ptrs = [x.data_ptr() for x in O.tree_leaves(cache)]
            got, new = M.decode_step(params, cfg, cache, tok, pos)
            assert new is cache
            assert [x.data_ptr() for x in O.tree_leaves(new)] == ptrs
            assert torch.equal(got, wl), f"{arch} step {t}"
            assert _equal(new, want), f"{arch} step {t}"


@pytest.mark.parametrize("window", [0, 4])
def test_attention_decode_in_place_equals_functional(window):
    """``apply_attention_decode`` alone, 7 steps into a 5-slot cache (a
    plain append, and a 4-position ring buffer that wraps): output and
    caches bitwise equal to the functional write's."""
    cfg = dataclasses.replace(_cfg("qwen3-14b"), sliding_window=window)
    p = M.init_params(cfg, torch.Generator().manual_seed(2),
                      device="cpu")["layers"][0]["attn"]
    p = {k: v[0] for k, v in p.items()}
    rng = np.random.default_rng(4)
    s = 5 if window == 0 else window
    shape = (3, s, cfg.n_kv_heads, cfg.hd())
    k, v = torch.zeros(shape), torch.zeros(shape)
    fk, fv = k.clone(), v.clone()
    for t in range(s if window == 0 else 7):
        x = torch.from_numpy(rng.standard_normal(
            (3, 1, cfg.d_model)).astype(np.float32))
        pos = torch.tensor([t, t, max(t - 1, 0)])
        want, fk, fv = functional_attention_decode(p, x, cfg, fk, fv, pos)
        got, k2, v2 = apply_attention_decode(p, x, cfg, k, v, pos)
        assert k2 is k and v2 is v
        assert torch.equal(got, want)
        assert torch.equal(k, fk) and torch.equal(v, fv)


# ---------------------------------------------------------------------------
# the prefill's conv tail
# ---------------------------------------------------------------------------


def test_prefill_conv_tail_is_a_copy_not_a_view_of_xbc():
    """The SSM prefill's conv tail (the decode handoff) owns a storage of
    its own size, not a view of the layer's whole projection (which kept
    every layer's ``xbc`` alive until the cache was stacked), and holds
    the same values as that view."""
    cfg = _cfg("mamba2-1.3b")
    p = M.init_params(cfg, torch.Generator().manual_seed(5),
                      device="cpu")["layers"][0]["ssm"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32))
    with torch.inference_mode():
        _, (tail, _) = SSM.apply_ssm_seq(p, x, cfg)
        _, xbc, _ = SSM._split_proj(x @ cx(p["in_proj"], cfg), cfg)
    view = xbc[:, -(cfg.ssm.conv_width - 1):, :]
    assert view.untyped_storage().nbytes() == xbc.untyped_storage().nbytes()
    assert tail.untyped_storage().nbytes() == tail.numel() * \
        tail.element_size()
    assert torch.equal(tail, view)
