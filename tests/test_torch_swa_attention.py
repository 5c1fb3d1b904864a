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
