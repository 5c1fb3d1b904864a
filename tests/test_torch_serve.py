"""The LM serving slice as a whole against the JAX package, on the CPU.

The JAX package's params (``repro.models.model.init_params``) are carried
across with ``repro_torch.convert.lm_params_from_numpy``; token, frame and
patch inputs are drawn with numpy and fed to both. All ten smoke configs
run in float32 at the sizes of ``tests/test_decode_consistency.py`` (32
tokens, batch 2, SSM chunk 8, sliding window 12 so the ring buffer
wraps). The kernel routes (``attn_impl="flash"`` for K5,
``ssm_impl="pallas"`` for K4) take their plain versions here; the JAX side
runs its Pallas kernels in interpret mode.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import serve as JS
from repro.models import model as JM
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as TS
from repro_torch.models import model as TM

torch.set_num_threads(1)

L, PRE, B = 32, 16, 2
KERNEL_ARCHS = {"mixtral-8x22b": "attn", "qwen3-14b": "attn",
                "mamba2-1.3b": "ssm", "jamba-v0.1-52b": "ssm"}
# the reference's bars: tests/test_kernel_model_integration.py (flash
# 2e-4, pallas SSM 3e-4) and tests/test_decode_consistency.py (2e-4)
TOL = {"naive": 2e-4, "attn": 2e-4, "ssm": 3e-4}


def _cfg(get, arch, impl="naive"):
    """The decode-consistency config of ``arch`` from one package's
    ``get_smoke_config``; ``impl`` "attn" / "ssm" turns the kernel on."""
    cfg = dataclasses.replace(get(arch), compute_dtype="float32")
    if cfg.ssm is not None:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               chunk=8))
    if cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=12)
    if impl == "attn":
        cfg = dataclasses.replace(cfg, attn_impl="flash")
    elif impl == "ssm":
        cfg = dataclasses.replace(cfg, ssm_impl="pallas")
    return cfg


def _batch(cfg, seed=7):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)}
    if cfg.encoder is not None:
        batch["frames"] = (rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.vision is not None:
        batch["patches"] = (rng.standard_normal(
            (B, cfg.vision.n_img_tokens, cfg.vision.d_vision))
            * 0.02).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v).to(torch.int64 if k == "tokens" else
                                      torch.float32)
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference(arch, impl):
    """(numpy params, numpy batch, JAX teacher-forced logits)."""
    cfg = _cfg(jax_smoke, arch, impl)
    params = JM.init_params(jax.random.PRNGKey(1), cfg)
    batch = _batch(cfg)
    logits, _ = JM.apply_train(params, cfg,
                               {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree.map(np.asarray, params), batch, np.asarray(logits)


def _cases():
    return [(a, "naive") for a in ARCH_IDS] + list(KERNEL_ARCHS.items())


@pytest.mark.parametrize("arch,impl", _cases())
def test_teacher_forced_logits_match_jax(arch, impl):
    params, batch, want = _reference(arch, impl)
    cfg = _cfg(torch_smoke, arch, impl)
    with torch.inference_mode():
        got, aux = TM.apply_train(lm_params_from_numpy(params, device="cpu"),
                                  cfg, _torch_batch(batch))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(aux)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL[impl],
                               atol=TOL[impl])


@pytest.mark.parametrize("arch,impl", _cases())
def test_prefill_then_decode_matches_teacher_forcing(arch, impl):
    """Prefill 16 tokens, convert the cache, decode the other 16 one at a
    time: every step's logits equal the JAX package's teacher-forced ones
    (KV caches, SWA ring buffer, SSM recurrence vs chunked SSD, MoE
    no-drop decode capacity, VLM prefix, whisper cross-attention)."""
    params, batch, want = _reference(arch, impl)
    cfg = _cfg(torch_smoke, arch, impl)
    tparams = lm_params_from_numpy(params, device="cpu")
    tb = _torch_batch(batch)
    with torch.inference_mode():
        pb = dict(tb, tokens=tb["tokens"][:, :PRE])
        pl, pcache = TM.prefill(tparams, cfg, pb)
        np.testing.assert_allclose(pl[:, 0].numpy(), want[:, PRE - 1],
                                   rtol=0, atol=2e-4)
        cache = TM.convert_prefill_cache(cfg, pcache, PRE, L,
                                         dtype=torch.float32)
        for t in range(PRE, L):
            lg, cache = TM.decode_step(tparams, cfg, cache,
                                       tb["tokens"][:, t:t + 1],
                                       torch.full((B,), t))
            np.testing.assert_allclose(lg[:, 0].numpy(), want[:, t], rtol=0,
                                       atol=2e-4, err_msg=f"{arch} step {t}")


def test_prefill_cache_layout_matches_init_cache():
    """The converted prefill cache has init_cache's shapes and dtypes, and
    a sliding-window cache is window-sized, not sequence-sized."""
    for arch in ("mixtral-8x22b", "jamba-v0.1-52b", "whisper-small"):
        cfg = _cfg(torch_smoke, arch)
        params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        batch = _torch_batch(_batch(cfg))
        with torch.inference_mode():
            _, pcache = TM.prefill(params, cfg, batch)
        conv = TM.convert_prefill_cache(cfg, pcache, L, 2048)
        init = TM.init_cache(cfg, B, 2048, device="cpu")
        assert len(conv) == len(init)
        for ce, ie in zip(conv, init):
            assert ce.keys() == ie.keys()
            for k in ce:
                assert ce[k].shape == ie[k].shape, (arch, k)
                assert ce[k].dtype == ie[k].dtype, (arch, k)
        if cfg.sliding_window:
            assert all(e["k"].shape[2] == cfg.sliding_window
                       for e in init if "k" in e)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "mamba2-1.3b"])
def test_generate_greedy_tokens_equal_jax(arch):
    """The serving example's configs (f32 smoke): greedy tokens equal
    ``repro.launch.serve.generate``'s, once through the plain routes and
    once through the kernel route of the family."""
    jcfg = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab, (4, 24))
    want = np.asarray(JS.generate(jcfg, params,
                                  jnp.asarray(prompts, jnp.int32), 12))
    tparams = lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                   device="cpu")
    base = dataclasses.replace(torch_smoke(arch), compute_dtype="float32")
    kernel = dataclasses.replace(base, **({"ssm_impl": "pallas"}
                                          if base.ssm is not None
                                          else {"attn_impl": "flash"}))
    for cfg in (base, kernel):
        got = TS.generate(cfg, tparams, torch.from_numpy(prompts), 12)
        assert got.shape == (4, 36)
        np.testing.assert_array_equal(got.numpy(), want)


def test_generate_samples_reproducibly():
    """Temperature sampling draws from a generator seeded by ``seed``: the
    same seed repeats the tokens, the prompt is kept, tokens are in the
    vocabulary."""
    cfg = dataclasses.replace(torch_smoke("mixtral-8x22b"),
                              compute_dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    prompts = torch.randint(0, cfg.vocab, (2, 8),
                            generator=torch.Generator().manual_seed(1))
    a = TS.generate(cfg, params, prompts, 6, temperature=0.8, seed=3)
    b = TS.generate(cfg, params, prompts, 6, temperature=0.8, seed=3)
    assert torch.equal(a, b) and torch.equal(a[:, :8], prompts)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab


def test_init_params_tree_matches_jax():
    """init_params builds the reference's tree: same keys, shapes and
    dtypes for every architecture (the stacked (n_super, ...) layers
    included), with the reference's init scales."""
    for arch in ARCH_IDS:
        jt = jax.eval_shape(lambda: JM.init_params(
            jax.random.PRNGKey(0), _cfg(jax_smoke, arch)))
        tt = TM.init_params(_cfg(torch_smoke, arch),
                            torch.Generator().manual_seed(0), device="cpu")
        jl, jdef = jax.tree_util.tree_flatten_with_path(jt)
        tl, tdef = jax.tree_util.tree_flatten_with_path(tt)
        assert [p for p, _ in jl] == [p for p, _ in tl], arch
        for (path, j), (_, t) in zip(jl, tl):
            assert tuple(t.shape) == j.shape, (arch, path)
            assert t.dtype == torch.float32, (arch, path)
    tt = TM.init_params(_cfg(torch_smoke, "mixtral-8x22b"),
                        torch.Generator().manual_seed(0), device="cpu")
    assert abs(float(tt["tok_embed"].std()) - 0.02) < 2e-3
    wq = tt["layers"][0]["attn"]["wq"]
    assert abs(float(wq.std()) * wq.shape[1] ** 0.5 - 1.0) < 0.05


def test_serve_main_runs_on_cpu(capsys):
    TS.main(["--arch", "mamba2-1.3b", "--reduced", "--batch", "2",
             "--prompt-len", "8", "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert '"total_shape": [2, 11]' in out and '"device": "cpu"' in out


def test_serve_batched_example_runs_on_cpu(capsys):
    from repro_torch.launch import serve_batched
    serve_batched.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in out] == ["mixtral-8x22b", "mamba2-1.3b"]
    assert all("-> (4, 36)" in ln for ln in out)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_chunked_lm_head_matches_jax(tied, monkeypatch):
    """``logits_from_h`` over chunks of the vocab (a decode step's few
    rows, no gradient taken) against the JAX package's one product, tied
    and with an untied ``unembed``, at a vocab of 4097 that the chunk
    (1024 here) does not divide; and against the port's own product over
    the whole table (gradient enabled): the same dots, which a CPU matmul
    may sum in another order for another width, so within 1e-6."""
    over = dict(vocab=4097, tie_embeddings=tied, compute_dtype="bfloat16")
    jcfg = dataclasses.replace(jax_smoke("qwen3-14b"), **over)
    cfg = dataclasses.replace(torch_smoke("qwen3-14b"), **over)
    params = jax.tree.map(np.asarray,
                          JM.init_params(jax.random.PRNGKey(3), jcfg))
    assert ("unembed" in params) != tied
    h = np.random.default_rng(5).standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32)
    want = np.asarray(JM.logits_from_h(jax.tree.map(jnp.asarray, params),
                                       jcfg, jnp.asarray(h)))
    tparams = lm_params_from_numpy(params, device="cpu")
    monkeypatch.setattr(TM, "LOGITS_CHUNK", 1024)
    with torch.no_grad():
        got = TM.logits_from_h(tparams, cfg, torch.from_numpy(h))
    whole = TM.logits_from_h(tparams, cfg, torch.from_numpy(h)).detach()
    assert got.shape == (B, 1, 4097) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got, whole, rtol=1e-6, atol=1e-6)
