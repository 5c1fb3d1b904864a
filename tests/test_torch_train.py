"""The LM training path of the port against the JAX package, on the CPU.

Token streams, cross-entropy, AdamW / SGD, the loss and its gradient for
all ten smoke configs, rematerialisation, and whole train steps. The JAX
package's params and AdamW state are carried across with
``repro_torch.convert.train_state_from_numpy``; batches are drawn with
numpy and fed to both. Float32, at the sizes of
``tests/test_torch_serve.py`` (batch 2 x 32 tokens, SSM chunk 8, sliding
window 12).

Bars: the loss within rtol 1e-5 (measured at most 3e-7); every gradient
leaf within relative L2 1e-4 of the reference's (measured at most 9e-6),
except leaves whose reference gradient is analytically zero (the key
biases of whisper, which softmax's shift invariance cancels: both sides
are rounding noise near 1e-9), held to 1e-6 of the global gradient norm.
After AdamW, parameters are held by a count: at step 1 m^/sqrt(v^) is
about sign(g), so a coordinate whose gradient is rounding noise can move
by up to 2 x lr the other way; at most MAX_FLIPPED of the coordinates may
lie outside 1e-5 (measured 1.4e-5 of them); the moments within relative
L2 1e-4 a leaf (measured at most 1.4e-5).
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
from repro.data import tokens as JT
from repro.models import model as JM
from repro.optim import optimizers as JO
from repro.train import steps as JS
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.data import tokens as TT
from repro_torch.models import model as TM
from repro_torch.optim import optimizers as TO
from repro_torch.train import steps as TS

torch.set_num_threads(1)

L, B = 32, 2
LOSS_RTOL, GRAD_REL_L2, ZERO_GRAD = 1e-5, 1e-4, 1e-6
MAX_FLIPPED = 1e-4


def _cfg(get, arch, remat="full"):
    cfg = dataclasses.replace(get(arch), compute_dtype="float32",
                              remat=remat)
    if cfg.ssm is not None:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               chunk=8))
    if cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=12)
    return cfg


def _batch(cfg, seed=7):
    """Tokens and labels (about a tenth masked) plus the stub frames /
    patches the encoder and vision configs read."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, L)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)}
    batch["labels"][rng.random((B, L)) < 0.1] = -1
    if cfg.encoder is not None:
        batch["frames"] = (rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.vision is not None:
        batch["patches"] = (rng.standard_normal(
            (B, cfg.vision.n_img_tokens, cfg.vision.d_vision))
            * 0.02).astype(np.float32)
    return batch


def _tb(batch):
    return {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(numpy params, numpy batch, loss, parts, numpy grads, leaf paths)."""
    cfg = _cfg(jax_smoke, arch)
    params = JM.init_params(jax.random.PRNGKey(1), cfg)
    batch = _batch(cfg)
    (loss, parts), grads = jax.value_and_grad(JS.loss_fn, has_aux=True)(
        params, cfg, _jb(batch))
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(grads)[0]]
    return (jax.tree.map(np.asarray, params), batch, float(loss),
            {k: float(v) for k, v in parts.items()}, _np_leaves(grads),
            paths)


def _assert_grads_close(want, got, paths):
    gnorm = np.sqrt(sum(float(np.sum(np.square(w))) for w in want))
    assert len(want) == len(got)
    for pth, w, g in zip(paths, want, got):
        assert w.shape == tuple(g.shape), pth
        err = float(np.linalg.norm(g.numpy() - w))
        ref = float(np.linalg.norm(w))
        if ref < ZERO_GRAD * gnorm:            # analytically zero
            assert err <= ZERO_GRAD * gnorm, (pth, err, gnorm)
        else:
            assert err <= GRAD_REL_L2 * ref, (pth, err / ref)


# ---------------------------------------------------------------------------
# token streams, cross-entropy, optimizers
# ---------------------------------------------------------------------------


def test_bigram_table_and_batches_bitwise():
    np.testing.assert_array_equal(TT.make_bigram_table(300, seed=3),
                                  JT.make_bigram_table(300, seed=3))
    want = list(JT.synthetic_lm_batches(300, 3, 20, 3, seed=5))
    got = list(TT.synthetic_lm_batches(300, 3, 20, 3, seed=5, device="cpu"))
    assert len(got) == 3
    for w, g in zip(want, got):
        for k in ("tokens", "labels"):
            assert g[k].dtype == torch.int64
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    # a vocab above 2048 draws from the 2048-token table, as the reference
    w = next(JT.synthetic_lm_batches(5000, 2, 8, 1, seed=2))
    g = next(TT.synthetic_lm_batches(5000, 2, 8, 1, seed=2, device="cpu"))
    np.testing.assert_array_equal(g["tokens"].numpy(),
                                  np.asarray(w["tokens"]))


@pytest.mark.parametrize("masked", [0.0, 0.3, 1.0])
def test_cross_entropy_masks_labels(masked):
    rng = np.random.default_rng(11)
    logits = (rng.standard_normal((3, 9, 17)) * 4).astype(np.float32)
    labels = rng.integers(0, 17, (3, 9)).astype(np.int32)
    labels[rng.random((3, 9)) < masked] = -1
    want = float(JS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = TS.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-6)
    if masked == 1.0:
        assert float(got) == 0.0               # divisor clamped at 1


def _opt_tree(rng, scale):
    f = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    return {"w": f(5, 7), "layers": ({"a": f(3, 4), "b": f(4)},
                                     {"a": f(3, 4), "b": f(4)}), "e": f(6)}


@pytest.mark.parametrize("grad_scale", [0.01, 3.0])
def test_adamw_update_matches_jax(grad_scale):
    """Three AdamW steps from the same params, grads and state: params,
    moments, step and the global norm within 1e-6 (grad_scale 3 clips)."""
    rng = np.random.default_rng(0)
    cfg = dict(lr=1e-2, warmup_steps=4, weight_decay=0.1, grad_clip=1.0)
    jcfg, tcfg = JO.AdamWConfig(**cfg), TO.AdamWConfig(**cfg)
    p = _opt_tree(rng, 1.0)
    jp = jax.tree.map(jnp.asarray, p)
    js = JO.adamw_init(jp)
    tp = lm_params_from_numpy(p, device="cpu")
    ts = TO.adamw_init(tp)
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    for _ in range(3):
        g = _opt_tree(rng, grad_scale)
        jp, js, jn = JO.adamw_update(jcfg, jp, jax.tree.map(jnp.asarray, g),
                                     js)
        tp, ts, tn = TO.adamw_update(tcfg, tp, lm_params_from_numpy(
            g, device="cpu"), ts)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for want, got in zip(_np_leaves((jp, js["m"], js["v"])),
                             TO.tree_leaves((tp, ts["m"], ts["v"]))):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6)
        assert int(ts["step"]) == int(js["step"])


def test_adamw_schedule_quirk_kept():
    """The step is incremented before the schedule reads step + 1: the
    first update runs at 2 / warmup_steps of lr, as the reference's."""
    cfg = TO.AdamWConfig(lr=1e-3, warmup_steps=10)
    lr1 = float(TO._schedule(cfg, torch.tensor(1, dtype=torch.int32)))
    assert lr1 == pytest.approx(2e-4, rel=1e-6)
    assert lr1 == pytest.approx(float(JO._schedule(
        JO.AdamWConfig(lr=1e-3, warmup_steps=10), jnp.int32(1))), rel=1e-7)
    # one update with a zero moment history and no decay moves each
    # coordinate by about lr1 (m^/sqrt(v^) = sign(g))
    p = {"w": torch.zeros(4)}
    g = {"w": torch.tensor([0.1, -0.2, 0.3, -0.4])}
    newp, _, _ = TO.adamw_update(dataclasses.replace(cfg, weight_decay=0.0),
                                 p, g, TO.adamw_init(p))
    np.testing.assert_allclose(newp["w"].numpy(),
                               -lr1 * np.sign(g["w"].numpy()), rtol=1e-4)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_update_matches_jax(momentum):
    rng = np.random.default_rng(1)
    p = _opt_tree(rng, 1.0)
    jp, tp = jax.tree.map(jnp.asarray, p), lm_params_from_numpy(p, "cpu")
    js, ts = JO.sgd_init(jp, momentum), TO.sgd_init(tp, momentum)
    assert sorted(js) == sorted(ts)
    for _ in range(2):
        g = _opt_tree(rng, 0.5)
        jp, js = JO.sgd_update(jp, jax.tree.map(jnp.asarray, g), js, 0.05,
                               momentum)
        tp, ts = TO.sgd_update(tp, lm_params_from_numpy(g, "cpu"), ts, 0.05,
                               momentum)
    for want, got in zip(_np_leaves(jp), TO.tree_leaves(tp)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_jax(arch):
    params, batch, loss, parts, grads, paths = _reference(arch)
    cfg = _cfg(torch_smoke, arch)
    (tl, tparts), tg = TS.value_and_grad(
        lm_params_from_numpy(params, device="cpu"), cfg, _tb(batch))
    np.testing.assert_allclose(float(tl), loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tparts["ce"]), parts["ce"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tparts["aux"]), parts["aux"],
                               rtol=LOSS_RTOL, atol=1e-7)
    _assert_grads_close(grads, TO.tree_leaves(tg), paths)


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-1.3b",
                                  "mixtral-8x22b", "whisper-small"])
def test_remat_policies_give_equal_grads(arch):
    """"none", "full" and "dots" give bitwise equal losses and gradients
    (rematerialisation changes no value), and "full" keeps fewer tensors
    alive for the backward pass than "none"."""
    params, batch, *_ = _reference(arch)
    tparams = lm_params_from_numpy(params, device="cpu")
    out, saved = {}, {}
    for remat in ("none", "full", "dots"):
        cfg = _cfg(torch_smoke, arch, remat)
        n = [0]

        def pack(t, n=n):
            n[0] += t.numel() * t.element_size()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out[remat] = TS.value_and_grad(tparams, cfg, _tb(batch))
        saved[remat] = n[0]
    (l0, _), g0 = out["none"]
    for remat in ("full", "dots"):
        (l1, _), g1 = out[remat]
        assert torch.equal(l0, l1)
        for a, b in zip(TO.tree_leaves(g0), TO.tree_leaves(g1)):
            assert torch.equal(a, b), remat
    assert saved["full"] < saved["none"]


def _grad_parents(loss):
    """{id of a param leaf: names of the graph nodes that feed its
    gradient accumulator}."""
    parents, seen, todo = {}, set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        for nxt, _ in node.next_functions:
            if nxt is None:
                continue
            if hasattr(nxt, "variable"):
                parents.setdefault(id(nxt.variable), []).append(node.name())
            todo.append(nxt)
    return parents


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "whisper-small"])
def test_stacked_layers_taken_apart_once(arch):
    """Each stacked (n_super, ...) leaf reaches autograd through one
    ``unbind``, whose backward is one ``stack``, not one ``select`` per
    superblock (each of which would allocate a zero gradient of the whole
    stacked leaf); apply_train builds no cache."""
    params, batch, *_ = _reference(arch)
    cfg = _cfg(torch_smoke, arch)
    leaves = TO.tree_map(lambda p: p.detach().requires_grad_(),
                         lm_params_from_numpy(params, device="cpu"))
    loss, _ = TS.loss_fn(leaves, cfg, _tb(batch))
    parents = _grad_parents(loss)
    stacked = TO.tree_leaves(leaves["layers"])
    if "encoder" in leaves:
        stacked += TO.tree_leaves(leaves["encoder"]["layers"])
    for leaf in stacked:
        assert parents[id(leaf)] == ["UnbindBackward0"], parents[id(leaf)]
    tb = _tb(batch)
    pos = TM._positions(tb["tokens"])
    with torch.no_grad():
        h = TM.embed_inputs(leaves, cfg, tb, pos)
        enc = (TM.apply_encoder(leaves, cfg, tb["frames"])
               if cfg.encoder is not None else None)
        h0, aux0, cache = TM.apply_stack_seq(leaves, cfg, h, pos, enc)
        h1, aux1, none = TM.apply_stack_seq(leaves, cfg, h, pos, enc,
                                            with_cache=False)
    assert none is None and cache is not None
    assert torch.equal(h0, h1) and torch.equal(aux0, aux1)


# ---------------------------------------------------------------------------
# whole train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-1.3b"])
def test_train_steps_match_jax(arch):
    """Three make_train_step steps from the reference's state on bigram
    batches: metrics every step, then moments, step and params."""
    jcfg, tcfg = _cfg(jax_smoke, arch), _cfg(torch_smoke, arch)
    opt = dict(lr=1e-3, warmup_steps=2)
    jstate = JS.init_train_state(jax.random.PRNGKey(3), jcfg)
    tstate = train_state_from_numpy(
        *jax.tree.map(np.asarray, (jstate.params, jstate.opt)), device="cpu")
    jstep = jax.jit(JS.make_train_step(jcfg, JO.AdamWConfig(**opt)))
    tstep = TS.make_train_step(tcfg, TO.AdamWConfig(**opt))
    for batch in JT.synthetic_lm_batches(jcfg.vocab, B, L, 3, seed=9):
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, _tb(jax.tree.map(np.asarray, batch)))
        for k in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, atol=1e-7)
    assert int(tstate.opt["step"]) == 3
    for want, got in zip(_np_leaves((jstate.opt["m"], jstate.opt["v"])),
                         TO.tree_leaves((tstate.opt["m"], tstate.opt["v"]))):
        err = np.linalg.norm(got.numpy() - want)
        assert err <= GRAD_REL_L2 * np.linalg.norm(want)
    want, got = _np_leaves(jstate.params), TO.tree_leaves(tstate.params)
    off = sum(int(np.sum(np.abs(g.numpy() - w) > 1e-5))
              for w, g in zip(want, got))
    total = sum(w.size for w in want)
    assert off <= MAX_FLIPPED * total, (off, total)
    worst = max(float(np.max(np.abs(g.numpy() - w)))
                for w, g in zip(want, got))
    assert worst <= 2 * 3 * opt["lr"]          # at most 2 lr a step
