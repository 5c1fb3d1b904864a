"""K5 (sliding-window flash attention) of the port against the JAX
package, on the CPU: the kernel's plain version against
``ops.swa_flash_attention`` in interpret mode and the
``ref.swa_attention_ref`` oracle, and the model's flash route against its
naive attention. Inputs are drawn with numpy and fed to both; the bars are
the reference's (2e-5 float32, 2e-2 bfloat16, ``tests/test_kernels.py``;
2e-4 for the model layer)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels import ops as JOPS
from repro.kernels import ref
from repro.models import layers as JL
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import swa_attention as K5
from repro_torch.models import layers as TL

torch.set_num_threads(1)

B, H, KH, HD = 2, 4, 2, 32
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(l, seed, dtype="float32", h=H, kh=KH, hd=HD):
    """q, k, v as numpy float32 arrays already rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    jdt = DTYPES[dtype][0]
    return tuple(np.array(jnp.asarray(rng.standard_normal(
        (B, l, n, hd)).astype(np.float32), jdt).astype(jnp.float32))
        for n in (h, kh, kh))


def _as(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return (tuple(jnp.asarray(a, jdt) for a in arrays),
            tuple(torch.from_numpy(a).to(tdt) for a in arrays))


def _heads_first(a, rep=1):
    """(B, L, n, hd) -> (B * n * rep, L, hd), kv heads repeated."""
    a = np.repeat(a, rep, axis=2)
    return a.transpose(0, 2, 1, 3).reshape(-1, a.shape[1], a.shape[3])


@pytest.mark.parametrize("l,window,bq,bk", [
    (128, 0, 32, 32),        # full causal
    (128, 48, 32, 32),       # sliding window
    (256, 64, 64, 64),
    (128, 16, 32, 32),       # window smaller than block
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(l, window, bq, bk, dtype):
    arrays = _qkv(l, l + window, dtype)
    (jq, jk, jv), (tq, tk, tv) = _as(arrays, dtype)
    want = JOPS.swa_flash_attention(jq, jk, jv, window=window, bq=bq, bk=bk,
                                    interpret=True)
    got = TOPS.swa_flash_attention(tq, tk, tv, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("l,window,causal", [(100, 0, True), (100, 30, True),
                                             (128, 48, False),
                                             (64, 0, False)])
def test_plain_matches_oracle(l, window, causal):
    """Any length (the reference kernel needs L % 128 == 0 above 128) and
    the non-causal forms, against the oracle in the reference's layout."""
    q, k, v = _qkv(l, 9 + l)
    want = ref.swa_attention_ref(*(jnp.asarray(_heads_first(a, r)) for a, r
                                   in ((q, 1), (k, H // KH), (v, H // KH))),
                                 window, causal=causal)
    got = K5.swa_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                           window, causal)
    got = _heads_first(got.numpy())
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


def test_flash_route_matches_model_attention_layer():
    """The model's flash route (K5) equals its naive attention and the JAX
    layer (mixtral smoke, window 48 < 64 tokens)."""
    jcfg = dataclasses.replace(jax_smoke("mixtral-8x22b"),
                               compute_dtype="float32", sliding_window=48)
    tcfg = dataclasses.replace(torch_smoke("mixtral-8x22b"),
                               compute_dtype="float32", sliding_window=48)
    p = JL.init_attention(jax.random.PRNGKey(0), jcfg)
    x = (np.random.default_rng(1).standard_normal((2, 64, jcfg.d_model))
         * 0.1).astype(np.float32)
    pos = np.broadcast_to(np.arange(64)[None], (2, 64))
    want, (wk, wv) = JL.apply_attention_seq(p, jnp.asarray(x), jcfg,
                                            jnp.asarray(pos))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    for impl in ("flash", "naive"):
        cfg = dataclasses.replace(tcfg, attn_impl=impl)
        got, (k, v) = TL.apply_attention_seq(tp, torch.from_numpy(x), cfg,
                                             torch.from_numpy(pos.copy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(k.numpy(), np.asarray(wk), rtol=2e-4,
                                   atol=2e-4)


def test_band_mask_and_masked_rows():
    m = K5.band_mask(6, 2, True, "cpu")
    assert m.tolist()[3] == [False, False, True, True, False, False]
    assert K5.band_mask(4, 0, False, "cpu").all()
    # with window 1 every row sees only itself: the output is v itself
    q, k, v = (torch.from_numpy(a) for a in _qkv(16, 4, h=2, kh=2))
    torch.testing.assert_close(K5.swa_attention(q, k, v, 1, True), v,
                               rtol=1e-6, atol=1e-6)


def test_cpu_route_and_input_checks():
    q, k, v = (torch.from_numpy(a) for a in _qkv(32, 2))
    before = K5.launches
    out = K5.swa_attention(q, k, v, 8)
    assert K5.launches == before             # the CPU takes the plain version
    assert torch.equal(out, K5.swa_attention_plain(q, k, v, 8))
    with pytest.raises(TypeError):
        K5.swa_attention(q, k.double(), v, 8)
    with pytest.raises(TypeError):
        K5.swa_attention(q.half(), k.half(), v.half(), 8)
    with pytest.raises(ValueError):          # 3 kv heads do not divide 4
        K5.swa_attention(q, torch.zeros(2, 32, 3, HD), torch.zeros(
            2, 32, 3, HD), 8)
    with pytest.raises(ValueError):
        K5.swa_attention(q, k[:, :16], v[:, :16], 8)
    with pytest.raises(ValueError):
        K5.swa_attention(q, k, v, -1)


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 32, "tensor_core"), (torch.bfloat16, 64, "tensor_core"),
    (torch.bfloat16, 128, "tensor_core"), (torch.bfloat16, 16, "tensor_core"),
    (torch.bfloat16, 96, "tensor_core"), (torch.float32, 32, "cuda_core"),
    (torch.float32, 128, "cuda_core"), (torch.bfloat16, 40, "cuda_core"),
    (torch.bfloat16, 8, "cuda_core"), (torch.bfloat16, 256, "cuda_core")])
def test_route_rule(dtype, hd, want):
    """bfloat16 with hd a multiple of 16 up to 128 takes the tensor-core
    instance; float32 and every other bfloat16 shape the CUDA-core one.
    The rule reads neither the window nor causality: non-causal inputs
    take the same instance."""
    assert K5.route(dtype, hd) == want


def test_tma_alignment_predicate():
    """TMA reads a tensor in place when its base is 16-byte aligned, its
    last axis contiguous and its other byte strides multiples of 16; the
    wrapper copies any other tensor."""
    x = torch.zeros((2, 24, 4, 64), dtype=torch.bfloat16)
    assert K5.tma_ready(x)
    assert K5.tma_ready(x[..., :48])             # 128-byte rows, 96 used
    assert K5.tma_ready(x.transpose(1, 2).contiguous().transpose(1, 2))
    assert not K5.tma_ready(x.flatten()[1:1 + 2 * 24 * 4 * 16].view(
        2, 24, 4, 16))                           # base off by 2 bytes
    assert not K5.tma_ready(x.transpose(2, 3))   # last axis strided
    assert not K5.tma_ready(torch.zeros((1, 8, 1, 20),
                                        dtype=torch.bfloat16))  # 40 B rows


def test_model_qkv_need_no_copy():
    """q, k and v as the attention layer hands them to K5 (from the
    projections' einsum and ``apply_rope``) are read in place by TMA."""
    cfg = dataclasses.replace(torch_smoke("mixtral-8x22b"),
                              compute_dtype="bfloat16")
    jcfg = dataclasses.replace(jax_smoke("mixtral-8x22b"),
                               compute_dtype="bfloat16")
    p = lm_params_from_numpy(jax.tree.map(
        np.asarray, JL.init_attention(jax.random.PRNGKey(0), jcfg)),
        device="cpu")
    x = torch.zeros((2, 40, cfg.d_model), dtype=torch.bfloat16)
    pos = torch.arange(40)[None].expand(2, 40)
    q, k, v = TL._qkv(p, x, x, cfg, pos, pos)
    assert K5.route(q.dtype, q.shape[3]) == "tensor_core"
    assert all(K5.tma_ready(t) for t in (q, k, v))


def _tc_emulation(q, k, v, window, causal, bq=128, bk=128):
    """The tensor-core instance's arithmetic on the CPU: the same walk
    over 128-row query blocks and 128-row key tiles of the band, bfloat16
    q, k, v, float32 sums, scores in base 2 with masked ones at -1e30, p
    rounded to bfloat16 for p.v while l sums the float32 p, the
    denominator clamped at 1e-30 and the output rounded to bfloat16."""
    b, l, h, hd = q.shape
    rep = h // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)                       # (b, h, l, hd)
    pad = (-l) % bk
    kf, vf = (torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
              .repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
              for t in (k, v))
    sl2 = torch.tensor(hd ** -0.5, dtype=torch.float32) * 1.4426950408889634
    out = torch.empty((b, h, l, hd))
    for i0 in range(0, l, bq):
        rows = torch.arange(i0, min(i0 + bq, l))
        last = min(l - 1, i0 + bq - 1) if causal else l - 1
        first = max(0, i0 - window + 1) if window else 0
        m = torch.full((b, h, len(rows)), -1e30)
        den = torch.zeros((b, h, len(rows)))
        o = torch.zeros((b, h, len(rows), hd))
        for j0 in range(first // bk * bk, last + 1, bk):
            cols = torch.arange(j0, j0 + bk)
            s = qf[:, :, rows] @ kf[:, :, j0:j0 + bk].transpose(2, 3)
            vis = cols[None] < l
            if causal:
                vis = vis & (cols[None] <= rows[:, None])
            if window:
                vis = vis & (cols[None] > rows[:, None] - window)
            s = torch.where(vis, s * sl2, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            den = den * alpha + p.sum(-1)
            o = o * alpha[..., None] \
                + p.to(torch.bfloat16).float() @ vf[:, :, j0:j0 + bk]
            m = m_new
        out[:, :, rows] = o / den.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


@pytest.mark.parametrize("l,window,causal,h,kh,hd", [
    (128, 0, True, 4, 2, 32), (128, 48, True, 4, 2, 32),
    (256, 64, True, 4, 2, 32), (128, 16, True, 4, 2, 32),
    (100, 0, True, 4, 2, 64), (100, 30, True, 4, 2, 64),
    (128, 48, False, 4, 1, 32), (64, 0, False, 2, 2, 32),
    (300, 130, True, 2, 1, 128),
    (2048, 1024, True, 2, 1, 128)])   # most rows far past the window
def test_tensor_core_rounding_within_the_bf16_bar(l, window, causal, h, kh,
                                                  hd):
    """An emulation of the tensor-core instance's rounding stays within
    the card's bfloat16 bars of ``swa_attention_plain``: 2e-2 a value, and
    1e-2 in relative L2 over the output (where it reads near 2e-3), so
    both bars have room for bfloat16 products and a bfloat16 p."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in
               _qkv(l, 31 + l + window, "bfloat16", h=h, kh=kh, hd=hd))
    got = _tc_emulation(q, k, v, window, causal).float()
    want = K5.swa_attention_plain(q, k, v, window, causal).float()
    assert got.shape == want.shape and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    assert float((got - want).norm() / want.norm()) <= 1e-2
