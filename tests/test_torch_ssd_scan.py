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
