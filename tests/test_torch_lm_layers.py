"""Units of the port's LM stack against the JAX package, on the CPU, at
smoke widths in float32: norms, RoPE, sinusoid positions, the three MLP
activations, self attention on its three routes, the ring-buffer decode
attention, cross attention, the cache fold, and the MoE router and
sort-based dispatch (with the properties of ``tests/test_moe_properties.py``).
JAX params are carried across with ``lm_params_from_numpy``; inputs are
drawn with numpy. Bar: 1e-5 for single layers (2e-4 where attention or
an expert MLP sums over a sequence)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MoEConfig as JMoEConfig
from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMOE
from repro_torch.configs import MoEConfig as TMoEConfig
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE

torch.set_num_threads(1)


def _cfgs(arch, **kw):
    """The f32 smoke config of ``arch`` in both packages."""
    return tuple(dataclasses.replace(get(arch), compute_dtype="float32", **kw)
                 for get in (jax_smoke, torch_smoke))


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tp(p):
    return lm_params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["qwen2-72b", "nemotron-4-15b"])
def test_norms_match_jax(arch):
    """rmsnorm (qwen2) and layernorm with population variance (nemotron),
    the qk head norm and the Mamba-2 gated norm."""
    jcfg, tcfg = _cfgs(arch)
    p = {k: _np(v.shape, 1) for k, v in JL.init_norm(jcfg, 256).items()}
    x = _np((2, 5, 256), 2, 3.0) + 1.0
    _close(TL.apply_norm(_tp(p), torch.from_numpy(x), tcfg),
           JL.apply_norm(p, jnp.asarray(x), jcfg))
    s, z = _np((256,), 3), _np((2, 5, 256), 4)
    _close(TL.rms_head_norm(torch.from_numpy(s), torch.from_numpy(x), 1e-5),
           JL.rms_head_norm(jnp.asarray(s), jnp.asarray(x), 1e-5))
    _close(TL.gated_rmsnorm(torch.from_numpy(s), torch.from_numpy(x),
                            torch.from_numpy(z), 1e-5),
           JL.gated_rmsnorm(jnp.asarray(s), jnp.asarray(x), jnp.asarray(z),
                            1e-5))


def test_rope_and_sinusoid_match_jax():
    x = _np((2, 7, 3, 32), 5)
    pos = np.array([[0, 1, 2, 3, 100, 4095, 70000]] * 2)
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 2e-5)
    _close(TL.sinusoid_positions(9, 16, "cpu", offset=3),
           JL.sinusoid_positions(9, 16, offset=3))


@pytest.mark.parametrize("arch", ["qwen2-72b", "whisper-small",
                                  "nemotron-4-15b"])
def test_mlp_matches_jax(arch):
    """swiglu, gelu (jax's tanh form) and squared relu."""
    jcfg, tcfg = _cfgs(arch)
    p = JL.init_mlp(jax.random.PRNGKey(0), jcfg, jcfg.d_model, jcfg.d_ff)
    x = _np((2, 6, jcfg.d_model), 6)
    _close(TL.apply_mlp(_tp(p), torch.from_numpy(x), tcfg),
           JL.apply_mlp(p, jnp.asarray(x), jcfg), 2e-5)


@pytest.mark.parametrize("arch,impl,window", [
    ("mixtral-8x22b", "naive", 20), ("mixtral-8x22b", "chunked", 20),
    ("mixtral-8x22b", "flash", 20), ("qwen3-14b", "chunked", 0),
    ("qwen2-72b", "naive", 0), ("qwen3-14b", "flash", 0)])
def test_attention_seq_matches_jax(arch, impl, window):
    """Self attention with qk-norm (qwen3), qkv bias (qwen2) and a window
    smaller than the sequence (mixtral); the chunked route at chunk 16 so
    the window slices the kv span."""
    jcfg, tcfg = _cfgs(arch, attn_impl=impl, sliding_window=window)
    p = JL.init_attention(jax.random.PRNGKey(1), jcfg)
    if "bq" in p:
        p = dict(p, bq=jnp.asarray(_np(p["bq"].shape, 7, 0.1)))
    x = _np((2, 64, jcfg.d_model), 8, 0.3)
    pos = np.broadcast_to(np.arange(64)[None], (2, 64)).copy()
    want, (wk, wv) = JL.apply_attention_seq(p, jnp.asarray(x), jcfg,
                                            jnp.asarray(pos))
    if impl == "chunked":    # the reference's chunk at a width that binds
        q, k, v = JL._qkv(p, jnp.asarray(x), jnp.asarray(x), jcfg,
                          jnp.asarray(pos), jnp.asarray(pos))
        want = jnp.einsum("bqhk,hkd->bqd",
                          JL._chunked_attention(q, k, v, jcfg, window, 16),
                          p["wo"])
        tq, tk, tv = TL._qkv(_tp(p), torch.from_numpy(x), torch.from_numpy(x),
                             tcfg, torch.from_numpy(pos),
                             torch.from_numpy(pos))
        got = torch.einsum("bqhk,hkd->bqd",
                           TL._chunked_attention(tq, tk, tv, tcfg, window,
                                                 16),
                           torch.tensor(np.asarray(p["wo"])))
    else:
        got, (k, v) = TL.apply_attention_seq(_tp(p), torch.from_numpy(x),
                                             tcfg, torch.from_numpy(pos))
        _close(v, wv, 2e-4)
    _close(got, want, 2e-4)


@pytest.mark.parametrize("window", [0, 6])
def test_attention_decode_ring_buffer_matches_jax(window):
    """Ten decode steps into an 8-slot cache: a plain append (window 0)
    and a ring buffer of 6 positions that wraps."""
    jcfg, tcfg = _cfgs("mixtral-8x22b", sliding_window=window)
    p = JL.init_attention(jax.random.PRNGKey(2), jcfg)
    s = 8 if window == 0 else window
    shape = (2, s, jcfg.n_kv_heads, jcfg.hd())
    jk, jv = jnp.zeros(shape), jnp.zeros(shape)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    tp = _tp(p)
    for t in range(s if window == 0 else 10):
        x = _np((2, 1, jcfg.d_model), 10 + t, 0.5)
        pos = np.array([t, t])
        want, jk, jv = JL.apply_attention_decode(p, jnp.asarray(x), jcfg, jk,
                                                 jv, jnp.asarray(pos))
        old = tk.clone()
        got, tk2, tv2 = TL.apply_attention_decode(tp, torch.from_numpy(x),
                                                  tcfg, tk, tv,
                                                  torch.from_numpy(pos))
        # the cache is consumed: written in place, the same tensor back
        assert tk2 is tk and tv2 is tv
        assert not torch.equal(tk, old)
        tk, tv = tk2, tv2
        _close(got, want, 2e-5)
        _close(tk, jk, 2e-5)


def test_slot_position_floor_mod_matches_jax():
    slots = np.arange(6)[None, :]
    pos = np.array([0, 3, 5, 6, 13])[:, None]
    want = JL._slot_position(jnp.asarray(slots), jnp.asarray(pos), 6)
    got = TL._slot_position(torch.from_numpy(slots), torch.from_numpy(pos),
                            6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.min()) < 0                # empty slots before the start


def test_cross_attention_matches_jax():
    jcfg, tcfg = _cfgs("whisper-small")
    p = JL.init_attention(jax.random.PRNGKey(3), jcfg, cross=True)
    x, enc = _np((2, 5, jcfg.d_model), 11), _np((2, 9, jcfg.d_model), 12)
    want, (wk, wv) = JL.apply_cross_attention_seq(p, jnp.asarray(x),
                                                  jnp.asarray(enc), jcfg)
    got, (k, v) = TL.apply_cross_attention_seq(_tp(p), torch.from_numpy(x),
                                               torch.from_numpy(enc), tcfg)
    _close(got, want, 2e-5)
    _close(TL.apply_cross_attention_cached(_tp(p), torch.from_numpy(x[:, :1]),
                                           k, v, tcfg),
           JL.apply_cross_attention_cached(p, jnp.asarray(x[:, :1]), wk, wv,
                                           jcfg), 2e-5)


@pytest.mark.parametrize("prefill_len", [5, 12, 17])
def test_convert_prefill_cache_matches_jax(prefill_len):
    """The fold of a prefill cache into ring order (window 8 < prefill),
    the pad (window >= prefill) for mixtral, and the pad of full attention
    (qwen2) to the target length."""
    for arch, window in (("mixtral-8x22b", 8), ("qwen2-72b", 0)):
        jcfg, tcfg = _cfgs(arch, sliding_window=window)
        kv = _np((1, 2, prefill_len, 2, 4), prefill_len)
        cache = ({"k": kv, "v": kv + 1},)
        want = JM.convert_prefill_cache(jcfg, tuple(
            {k: jnp.asarray(v) for k, v in e.items()} for e in cache),
            prefill_len, 20)
        got = TM.convert_prefill_cache(tcfg, tuple(
            {k: torch.from_numpy(v) for k, v in e.items()} for e in cache),
            prefill_len, 20)
        for name in ("k", "v"):
            np.testing.assert_array_equal(got[0][name].numpy(),
                                          np.asarray(want[0][name]))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_cfgs(e=4, k=2, dff=64, act="swiglu"):
    return tuple(dataclasses.replace(
        get("mixtral-8x22b"), compute_dtype="float32", d_model=32,
        mlp_act=act, moe=M(n_experts=e, top_k=k, d_ff_expert=dff, every=1))
        for get, M in ((jax_smoke, JMoEConfig), (torch_smoke, TMoEConfig)))


def test_router_topk_matches_jax():
    jcfg, tcfg = _moe_cfgs()
    p = JMOE.init_moe(jax.random.PRNGKey(0), jcfg, jcfg.d_model)
    x = _np((40, jcfg.d_model), 13)
    g, i, a = JMOE.router_topk(p, jnp.asarray(x), jcfg)
    tg, ti, ta = TMOE.router_topk(_tp(p), torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(i))
    _close(tg, g)
    _close(ta, a)
    np.testing.assert_allclose(tg.sum(-1).numpy(), 1.0, atol=1e-5)


def test_router_ties_go_to_the_lower_expert():
    """Equal router logits: lax.top_k's order, the lower index first."""
    _, tcfg = _moe_cfgs(e=4, k=2)
    p = {"router": torch.zeros(tcfg.d_model, 4)}
    _, idx, _ = TMOE.router_topk(p, torch.ones(3, tcfg.d_model), tcfg)
    assert idx.tolist() == [[0, 1]] * 3


@pytest.mark.parametrize("t,e,k,capacity", [(12, 4, 2, 12), (40, 3, 2, 9),
                                            (25, 8, 4, 3)])
def test_dispatch_indices_match_jax(t, e, k, capacity):
    rng = np.random.default_rng(t)
    idx = np.stack([rng.permutation(e)[:k] for _ in range(t)])
    want = JMOE._dispatch_indices(jnp.asarray(idx), e, capacity)
    got = TMOE._dispatch_indices(torch.from_numpy(idx), e, capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    slot, keep, _, sorted_e = got
    kept = slot[keep].numpy()
    assert len(np.unique(kept)) == len(kept)         # no collisions
    assert (slot.numpy() // capacity == sorted_e.numpy()).all()
    if capacity >= t:
        assert bool(keep.all())


@pytest.mark.parametrize("t,act", [(24, "swiglu"), (24, "gelu"),
                                   (4200, "swiglu")])
def test_apply_moe_matches_jax(t, act):
    """Both capacity branches: t <= 4096 keeps every token; 4200 tokens
    over 4 experts keep 1.25 * t * k / E slots each and drop the rest."""
    jcfg, tcfg = _moe_cfgs(act=act)
    assert TMOE.capacity_of(tcfg, t) == (t if t <= 4096 else 2625)
    p = JMOE.init_moe(jax.random.PRNGKey(1), jcfg, jcfg.d_model)
    x = _np((1, t, jcfg.d_model), 14)
    want, waux = JMOE.apply_moe(p, jnp.asarray(x), jcfg)
    got, aux = TMOE.apply_moe(_tp(p), torch.from_numpy(x), tcfg)
    _close(got, want, 2e-5)
    _close(aux, waux)


def test_moe_is_permutation_equivariant():
    """Token order does not change per-token outputs (no drops)."""
    _, tcfg = _moe_cfgs()
    p = TMOE.init_moe(torch.Generator().manual_seed(0), tcfg, tcfg.d_model,
                      "cpu")
    x = torch.from_numpy(_np((1, 32, tcfg.d_model), 15))
    perm = torch.from_numpy(np.random.default_rng(2).permutation(32))
    out, _ = TMOE.apply_moe(p, x, tcfg)
    out_p, _ = TMOE.apply_moe(p, x[:, perm], tcfg)
    torch.testing.assert_close(out[:, perm], out_p, rtol=1e-5, atol=1e-5)


def test_moe_top1_token_equals_its_expert_mlp():
    """With one expert per token the output is that expert's MLP of the
    token itself (no cross-token leakage)."""
    _, tcfg = _moe_cfgs(e=2, k=1)
    p = TMOE.init_moe(torch.Generator().manual_seed(0), tcfg, tcfg.d_model,
                      "cpu")
    x = torch.from_numpy(_np((1, 8, tcfg.d_model), 16))
    out, _ = TMOE.apply_moe(p, x, tcfg)
    _, idx, _ = TMOE.router_topk(p, x.reshape(8, -1), tcfg)
    for t in range(8):
        e, xt = int(idx[t, 0]), x[0, t]
        h = torch.nn.functional.silu(xt @ p["wg"][e]) * (xt @ p["wi"][e])
        torch.testing.assert_close(out[0, t], h @ p["wo"][e], rtol=1e-5,
                                   atol=1e-5)
