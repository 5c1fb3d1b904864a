"""K4 (the SSD intra-chunk stage) and the Mamba-2 mixer of the port against
the JAX package, on the CPU: the kernel's plain version against
``ssd_chunk_pallas`` in interpret mode and the ``ref.ssd_chunk_ref``
oracle, the chunked scan around it against ``ops.ssd_chunked_kernel`` and
``models.ssm.ssd_chunked``, and the mixer's sequence and decode paths.
Inputs are drawn with numpy and fed to both; the bar is the reference's
(rtol = atol = 2e-4, ``tests/test_kernels.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels import ops as JOPS
from repro.kernels import ref
from repro.kernels.ssd_scan import ssd_chunk_pallas
from repro.models import ssm as JSSM
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ssd_scan as K4
from repro_torch.models import ssm as TSSM

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
# tests/test_kernels.py's (b, l, h, p, n, g, chunk) cases
CASES = [(1, 64, 2, 16, 16, 1, 16), (2, 128, 4, 32, 32, 2, 32),
         (1, 96, 2, 64, 128, 1, 32)]


def _inputs(b, l, h, p, n, g, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, l, h, p)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(f)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(f)
    B = (rng.standard_normal((b, l, g, n)) * 0.5).astype(f)
    C = (rng.standard_normal((b, l, g, n)) * 0.5).astype(f)
    return x, dt, A, B, C


def _chunked(arrays, chunk):
    """(b, l, ...) inputs -> the kernel's (b, nc, c, ...) layout."""
    x, dt, A, B, C = arrays
    b, l = x.shape[:2]
    nc = l // chunk
    return (x.reshape(b, nc, chunk, *x.shape[2:]),
            dt.reshape(b, nc, chunk, dt.shape[2]), A,
            B.reshape(b, nc, chunk, *B.shape[2:]),
            C.reshape(b, nc, chunk, *C.shape[2:]))


def _t(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("b,l,h,p,n,g,chunk", CASES)
def test_plain_matches_pallas_interpret_and_oracle(b, l, h, p, n, g, chunk):
    x, dt, A, B, C = _chunked(_inputs(b, l, h, p, n, g, l + h), chunk)
    rep = h // g
    Bh, Ch = np.repeat(B, rep, axis=3), np.repeat(C, rep, axis=3)
    jargs = tuple(jnp.asarray(a) for a in (x, dt, A, Bh, Ch))
    y_pl, st_pl = ssd_chunk_pallas(*jargs, interpret=True)
    y_ref, st_ref = ref.ssd_chunk_ref(*jargs)
    # the port takes B and C at group width and at head width alike
    for Bt, Ct in ((B, C), (Bh, Ch)):
        y, st = K4.ssd_chunk(*_t((x, dt, A, Bt, Ct)))
        for want_y, want_st in ((y_pl, st_pl), (y_ref, st_ref)):
            np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
            np.testing.assert_allclose(st.numpy(), np.asarray(want_st),
                                       **TOL)


@pytest.mark.parametrize("b,l,h,p,n,g,chunk", CASES)
def test_chunked_scan_matches_jax(b, l, h, p, n, g, chunk):
    """ops.ssd_chunked_kernel (K4 plus the inter-chunk recurrence) and the
    plain ssm.ssd_chunked against the JAX package's two routes."""
    arrays = _inputs(b, l, h, p, n, g, l + h)
    jargs = tuple(jnp.asarray(a) for a in arrays)
    y_k, st_k = JOPS.ssd_chunked_kernel(*jargs, chunk, interpret=True)
    y_j, st_j = JSSM.ssd_chunked(*jargs, chunk)
    for fn in (TOPS.ssd_chunked_kernel, TSSM.ssd_chunked):
        y, st = fn(*_t(arrays), chunk)
        for want_y, want_st in ((y_k, st_k), (y_j, st_j)):
            np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
            np.testing.assert_allclose(st.numpy(), np.asarray(want_st),
                                       **TOL)


def test_chunked_scan_with_initial_state():
    b, l, h, p, n, chunk = 1, 64, 2, 16, 16, 16
    arrays = _inputs(b, l, h, p, n, 1, 0)
    st0 = (np.random.default_rng(1).standard_normal((b, h, p, n))
           * 0.1).astype(np.float32)
    jargs = tuple(jnp.asarray(a) for a in arrays)
    y_w, f_w = JSSM.ssd_chunked(*jargs, chunk, init_state=jnp.asarray(st0))
    y_k, f_k = JOPS.ssd_chunked_kernel(*jargs, chunk,
                                       init_state=jnp.asarray(st0),
                                       interpret=True)
    for fn in (TOPS.ssd_chunked_kernel, TSSM.ssd_chunked):
        y, f = fn(*_t(arrays), chunk, init_state=torch.from_numpy(st0))
        for want_y, want_f in ((y_w, f_w), (y_k, f_k)):
            np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
            np.testing.assert_allclose(f.numpy(), np.asarray(want_f), **TOL)


def test_no_overflow_above_the_diagonal():
    """A strongly negative A makes exp(cs_i - cs_j) overflow for j > i;
    the select keeps every output finite (never inf * 0)."""
    x, dt, A, B, C = _chunked(_inputs(1, 64, 2, 16, 16, 1, 3), 64)
    A = np.full_like(A, -60.0)
    y, st = K4.ssd_chunk(*_t((x, dt, A, B, C)))
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    y_ref, st_ref = ref.ssd_chunk_ref(*(jnp.asarray(a)
                                        for a in (x, dt, A, B, C)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)


def test_cpu_route_and_input_checks():
    args = _t(_chunked(_inputs(1, 32, 4, 8, 8, 2, 5), 16))
    before = K4.launches
    y, st = K4.ssd_chunk(*args)
    assert K4.launches == before            # the CPU takes the plain version
    y_p, st_p = K4.ssd_chunk_plain(*args)
    assert torch.equal(y, y_p) and torch.equal(st, st_p)
    x, dt, A, B, C = args
    with pytest.raises(TypeError):
        K4.ssd_chunk(x.double(), dt, A, B, C)
    with pytest.raises(ValueError):          # g = 3 does not divide h = 4
        K4.ssd_chunk(x, dt, A, B[..., :1, :].expand(-1, -1, -1, 3, -1), C)
    with pytest.raises(ValueError):
        K4.ssd_chunk(x, dt[..., :2], A, B, C)
    with pytest.raises(ValueError):          # l not a multiple of chunk
        TOPS.ssd_chunked_kernel(torch.zeros(1, 10, 4, 8),
                                torch.zeros(1, 10, 4), A,
                                torch.zeros(1, 10, 2, 8),
                                torch.zeros(1, 10, 2, 8), 4)


def _ssm_cfg(get, chunk=16):
    cfg = dataclasses.replace(get("mamba2-1.3b"), compute_dtype="float32")
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                            chunk=chunk))


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_apply_ssm_seq_matches_jax(impl):
    """The whole mixer (in_proj, causal conv, softplus dt, SSD, D skip,
    gated norm, out_proj) on the plain route and on K4's."""
    jcfg = dataclasses.replace(_ssm_cfg(jax_smoke), ssm_impl=impl)
    tcfg = dataclasses.replace(_ssm_cfg(torch_smoke), ssm_impl=impl)
    p = JSSM.init_ssm(jax.random.PRNGKey(0), jcfg)
    x = (np.random.default_rng(2).standard_normal((2, 64, jcfg.d_model))
         * 0.5).astype(np.float32)
    want, (wtail, wstate) = JSSM.apply_ssm_seq(p, jnp.asarray(x), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    got, (tail, state) = TSSM.apply_ssm_seq(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tail.numpy(), np.asarray(wtail), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(wstate), **TOL)


def test_apply_ssm_decode_matches_jax():
    """Four recurrent decode steps from a non-zero state."""
    jcfg, tcfg = _ssm_cfg(jax_smoke), _ssm_cfg(torch_smoke)
    p = JSSM.init_ssm(jax.random.PRNGKey(1), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    rng = np.random.default_rng(3)
    jst = JSSM.init_ssm_state(jcfg, 2)
    tst = TSSM.init_ssm_state(tcfg, 2, "cpu")
    for k in jst:
        assert tuple(tst[k].shape) == jst[k].shape
    init = {k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
            for k, v in jst.items()}
    jst = {k: jnp.asarray(v) for k, v in init.items()}
    tst = {k: torch.from_numpy(v) for k, v in init.items()}
    for _ in range(4):
        x = (rng.standard_normal((2, 1, jcfg.d_model)) * 0.5).astype(
            np.float32)
        want, jst = JSSM.apply_ssm_decode(p, jnp.asarray(x), jcfg, jst)
        got, tst = TSSM.apply_ssm_decode(tp, torch.from_numpy(x), tcfg, tst)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for k in jst:
            np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                       **TOL)


def test_init_ssm_draws_the_reference_distributions():
    cfg = _ssm_cfg(torch_smoke)
    p = TSSM.init_ssm(torch.Generator().manual_seed(0), cfg, "cpu", lead=(3,))
    jp = JSSM.init_ssm(jax.random.PRNGKey(0), _ssm_cfg(jax_smoke))
    for k, v in jp.items():
        assert tuple(p[k].shape) == (3,) + v.shape, k
    np.testing.assert_allclose(p["A_log"][1].numpy(), np.asarray(jp["A_log"]))
    s = cfg.ssm
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert float(dt.min()) >= s.dt_min * 0.999
    assert float(dt.max()) <= s.dt_max * 1.001


# chip_smoke.py phase 8's seven K4 shapes (b, nc, c, h, p, g, n), the
# full-width mamba2-1.3b prefill shape cut to one (batch, chunk, head) slice
PHASE8_SHAPES = [(1, 4, 16, 2, 16, 1, 16), (2, 4, 32, 4, 32, 2, 32),
                 (1, 3, 32, 2, 64, 1, 128), (2, 2, 32, 4, 32, 4, 32),
                 (1, 2, 100, 4, 64, 2, 32), (4, 1, 24, 16, 32, 1, 32),
                 (1, 1, 256, 1, 64, 1, 128)]


def _tf32(a):
    """float32 -> TF32 (10 mantissa bits), round to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds: add half a unit of the
    13 dropped bits to the magnitude, then clear them."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_split(a, b):
    """a @ b as the tensor-core instance takes it: each operand split into
    big = tf32(v) and small = tf32(v - big), three TF32 products (exact in
    float32) summed in float32, the small cross terms first."""
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _tf32(a - ab), _tf32(b - bb)
    return as_ @ bb + ab @ bs + ab @ bb


def _split_tf32_emulation(x, dt, A, B, C, mm=_mm_split):
    """The arithmetic of ``csrc/ssd_scan_tc.cu`` on the CPU: S = C.B^T
    through ``mm``, W = S * exp(cs_i - cs_j) * dt_j in float32 (zero above
    the diagonal), y = W.x and states = x^T.(B * dt * exp(cs_last - cs))
    through ``mm``."""
    h = x.shape[3]
    Bh = K4._heads(B, h).permute(0, 1, 3, 2, 4)          # (b,nc,h,c,n)
    Ch = K4._heads(C, h).permute(0, 1, 3, 2, 4)
    xh = x.permute(0, 1, 3, 2, 4)                         # (b,nc,h,c,p)
    cs = torch.cumsum(dt * A, dim=2).permute(0, 1, 3, 2)  # (b,nc,h,c)
    dth = dt.permute(0, 1, 3, 2)
    c = x.shape[2]
    tril = torch.tril(torch.ones((c, c), dtype=torch.bool))
    seg = cs[..., :, None] - cs[..., None, :]
    L = torch.where(tril, torch.exp(torch.where(tril, seg, 0.0)), 0.0)
    W = mm(Ch, Bh.transpose(-1, -2)) * L * dth[..., None, :]
    y = mm(W, xh).permute(0, 1, 3, 2, 4)
    dec = dth * torch.exp(cs[..., -1:] - cs)
    st = mm(xh.transpose(-1, -2), Bh * dec[..., None])
    return y, st


def _phase8_inputs(shape, seed):
    """chip_smoke.ssd_inputs' distributions, drawn with numpy."""
    b, nc, c, h, p, g, n = shape
    rng = np.random.default_rng(seed)

    def rn(*sh):
        return torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
    dt = torch.nn.functional.softplus(rn(b, nc, c, h))
    return (rn(b, nc, c, h, p), dt, -torch.exp(rn(h) * 0.3),
            rn(b, nc, c, g, n) * 0.5, rn(b, nc, c, g, n) * 0.5)


@pytest.mark.parametrize("shape", PHASE8_SHAPES)
def test_split_tf32_emulation_within_the_bar(shape):
    """The tensor-core instance's 3xTF32 arithmetic, emulated on the CPU,
    stays within the 2e-4 bar of ``ssd_chunk_plain`` at every shape of
    phase 8 (which all route to it)."""
    b, nc, c, h, p, g, n = shape
    assert K4.route(c, p, n) == "tensor_core"
    args = _phase8_inputs(shape, sum(shape))
    y, st = _split_tf32_emulation(*args)
    y_want, st_want = K4.ssd_chunk_plain(*args)
    torch.testing.assert_close(y, y_want, **TOL)
    torch.testing.assert_close(st, st_want, **TOL)


def test_single_pass_tf32_misses_the_bar():
    """Why the split: one TF32 product per pair, at the prefill slice,
    lands far outside the 2e-4 bar that the split keeps."""
    args = _phase8_inputs(PHASE8_SHAPES[-1], 1)
    y, _ = _split_tf32_emulation(*args, mm=lambda a, b: _tf32(a) @ _tf32(b))
    y_want, _ = K4.ssd_chunk_plain(*args)
    assert float((y - y_want).abs().max()) > 10 * TOL["atol"]


def test_route_rule():
    """p, n <= 128 with the tiles inside one block's 227 KB of shared
    memory take the tensor cores (every config's: mamba2-1.3b and jamba
    at d_state 128, head 64, chunk 256; their smoke configs at 32 / 32),
    the rest the CUDA cores."""
    assert K4.tc_smem_bytes(256, 64, 128) == 4 * (768 + 4 * 64 * 132
                                                   + 2 * 64 * 72 + 64 * 68)
    for c, p, n in ((256, 64, 128), (32, 32, 32), (100, 64, 32),
                    (3584, 64, 128), (832, 128, 128), (24, 1, 1)):
        assert K4.route(c, p, n) == "tensor_core"
    for c, p, n in ((256, 64, 160), (3585, 64, 128), (833, 128, 128),
                    (256, 129, 32), (64, 16, 256)):
        assert K4.route(c, p, n) == "cuda_core"
