"""Port parity: the on-board CNN/MLP and the cohort trainer of
``repro_torch`` against the JAX package, with the same weights, data and
minibatch order (numpy inputs from a seed; permutations drawn with the
reference's keys)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.client import local_sgd_clients as jax_clients
from repro.models import small as J
from repro_torch.convert import params_from_numpy as _to_torch
from repro_torch.core.client import local_sgd, local_sgd_clients
from repro_torch.models import small as T

torch.set_num_threads(1)

SHAPE, NCLS = (28, 28, 1), 62


def params_from_numpy(tree):
    """The reference's parameters as CPU tensors (the port's default
    device is the card)."""
    return _to_torch(tree, device="cpu")


def _cnn_params(seed=0):
    p = J.init_cnn(jax.random.PRNGKey(seed), SHAPE, NCLS)
    rng = np.random.default_rng(seed)
    # non-zero biases, so the bias layouts are checked too
    return {k: np.asarray(v) + (0.05 * rng.standard_normal(v.shape)
                                .astype(np.float32) if k[0] == "b" else 0)
            for k, v in p.items()}


def _data(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def test_cnn_shapes_match_reference():
    p = _cnn_params()
    assert [p[k].shape for k in ("conv1", "b1", "conv2", "b2", "dense",
                                 "bd", "out", "bo")] == \
        [(3, 3, 1, 16), (16,), (3, 3, 16, 32), (32,), (1568, 128), (128,),
         (128, 62), (62,)]
    assert sum(v.size for v in p.values()) == 213_630


@pytest.mark.parametrize("model", ["cnn", "mlp"])
def test_logits_match_reference(model):
    if model == "cnn":
        p = _cnn_params(1)
    else:
        p = {k: np.asarray(v) for k, v in
             J.init_mlp(jax.random.PRNGKey(1), SHAPE, NCLS).items()}
    x = _data(2, (8,) + SHAPE)
    want = np.asarray(J.MODELS[model][1](p, jnp.asarray(x)))
    got = T.MODELS[model][1](params_from_numpy(p), torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)


def test_cnn_grads_match_reference():
    p = _cnn_params(3)
    x = _data(4, (16,) + SHAPE)
    y = np.random.default_rng(5).integers(0, NCLS, 16)
    want = jax.grad(lambda q: J.xent_loss(J.apply_cnn, q, jnp.asarray(x),
                                          jnp.asarray(y, jnp.int32)))(p)
    got = torch.func.grad(lambda q: T.xent_loss(
        T.apply_cnn, q, torch.from_numpy(x), torch.from_numpy(y)))(
            params_from_numpy(p))
    for k in p:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, err_msg=k)


def test_same_padding_rule():
    # XLA "SAME", stride 2: an even size pads one row/column bottom/right
    assert T._same_pad(28, 3, 2) == (0, 1)
    assert T._same_pad(14, 3, 2) == (0, 1)
    assert T._same_pad(7, 3, 2) == (1, 1)
    assert T._same_pad(5, 3, 1) == (1, 1)


def _perms(keys, n, n_epochs):
    """The reference trainer's minibatch orders: per epoch, ``k, sub =
    split(k)`` then ``permutation(sub, n)``."""
    out = []
    for key in keys:
        rows, k = [], key
        for _ in range(n_epochs):
            k, sub = jax.random.split(k)
            rows.append(np.asarray(jax.random.permutation(sub, n)))
        out.append(np.stack(rows))
    return torch.from_numpy(np.stack(out).astype(np.int64))


def _cohort(W=5, n=32):
    p = _cnn_params(6)
    stacked = {k: np.broadcast_to(v, (W,) + v.shape).copy()
               for k, v in p.items()}
    xs = _data(7, (W, n) + SHAPE)
    ys = np.random.default_rng(8).integers(0, NCLS, (W, n))
    keys = jax.random.split(jax.random.PRNGKey(9), W)
    return stacked, xs, ys, keys


def test_local_sgd_clients_matches_reference():
    """Per-client dynamic epochs [2, 0, 1, 2, 2], batch 16 over 32 samples
    (2 SGD steps per epoch), same permutations: params agree at 1e-5."""
    stacked, xs, ys, keys = _cohort()
    epochs = np.array([2, 0, 1, 2, 2], np.int32)
    want = jax_clients("cnn", stacked, jnp.asarray(xs),
                       jnp.asarray(ys, jnp.int32), keys, epochs, 16, 0.05)
    got = local_sgd_clients("cnn", params_from_numpy(stacked),
                            torch.from_numpy(xs), torch.from_numpy(ys),
                            _perms(keys, 32, 2), epochs, 16, 0.05)
    for k in stacked:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)


def test_finished_clients_stay_frozen():
    """A client whose epoch budget is spent keeps its parameters bitwise
    while the others run on; a client's result does not depend on how long
    the rest of the cohort trains."""
    stacked, xs, ys, keys = _cohort()
    perms = _perms(keys, 32, 3)
    args = (params_from_numpy(stacked), torch.from_numpy(xs),
            torch.from_numpy(ys), perms)
    a = local_sgd_clients("cnn", *args, np.array([0, 1, 3, 1, 2]), 16, 0.05)
    b = local_sgd_clients("cnn", *args, np.array([0, 1, 1, 1, 1]), 16, 0.05)
    for k, v in stacked.items():
        np.testing.assert_array_equal(a[k][0].numpy(), v[0])
        np.testing.assert_array_equal(a[k][1].numpy(), b[k][1].numpy())
        np.testing.assert_array_equal(a[k][3].numpy(), b[k][3].numpy())
        assert not np.array_equal(a[k][2].numpy(), b[k][2].numpy())


def test_local_sgd_single_client_is_cohort_row():
    stacked, xs, ys, keys = _cohort(W=2)
    perms = _perms(keys, 32, 2)
    cohort = local_sgd_clients("cnn", params_from_numpy(stacked),
                               torch.from_numpy(xs), torch.from_numpy(ys),
                               perms, 2, 16, 0.05)
    one = local_sgd("cnn", {k: torch.from_numpy(v[1]) for k, v in
                            stacked.items()}, torch.from_numpy(xs[1]),
                    torch.from_numpy(ys[1]), perms[1], 2, 16, 0.05)
    for k in stacked:
        np.testing.assert_allclose(one[k].numpy(), cohort[k][1].numpy(),
                                   atol=1e-6)


def test_accuracy_and_bytes_match_reference():
    p = _cnn_params(10)
    x = _data(11, (300,) + SHAPE)
    y = np.random.default_rng(12).integers(0, NCLS, 300)
    tp = params_from_numpy(p)
    logits = np.asarray(J.apply_cnn(p, jnp.asarray(x)))
    top2 = np.sort(logits, -1)[:, -2:]
    assert np.all(top2[:, 1] - top2[:, 0] > 1e-4)    # no near-ties here
    assert T.accuracy(T.apply_cnn, tp, torch.from_numpy(x),
                      torch.from_numpy(y)) == \
        J.accuracy(J.apply_cnn, p, jnp.asarray(x), jnp.asarray(y, jnp.int32))
    assert T.model_bytes(tp, 10) == J.model_bytes(p, 10)
