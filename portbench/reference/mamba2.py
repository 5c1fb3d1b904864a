"""Plain Mamba-2 language model (arXiv:2405.21060), float32.

Each layer: pre-norm (RMSNorm); one input projection to the gate z, the
SSM input x, B, C and the step dt; a causal depthwise convolution over
(x, B, C) with bias and SiLU; dt = softplus(dt + dt_bias), A = -exp(A_log);
the SSD, computed by the paper's minimal chunked algorithm (its Listing
1: quadratic inside a chunk, a recurrence over chunk states); the skip
y + D x; the gated RMSNorm of y * silu(z); the output projection; the
residual. Then a final RMSNorm and the lm head tied to the embedding.

Weights are the benchmark's dict of dotted path -> stacked tensor (one
slice a layer), or, for training, the dict this module's
``layer_params`` makes: one float32 leaf a layer and path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.costs import ssd_forward_flops
from portbench.reference.common import Precision, rmsnorm

LAYER_KEYS = ("norm1.scale", "ssm.in_proj", "ssm.conv_w", "ssm.conv_b",
              "ssm.A_log", "ssm.D", "ssm.dt_bias", "ssm.norm_scale",
              "ssm.out_proj")
PREFIX = "layers.0."


def dims(cfg):
    s = cfg["ssm"]
    d_in = s["expand"] * cfg["d_model"]
    return d_in, d_in // s["head_dim"], s["n_groups"] * s["d_state"]


def param_shapes(cfg):
    """{path: shape} of the model's parameters, each layer's stacked over
    a leading layer axis (the program takes this tree)."""
    s, d, n = cfg["ssm"], cfg["d_model"], cfg["n_layers"]
    d_in, h, gn = dims(cfg)
    ch = d_in + 2 * gn
    layer = {"norm1.scale": (d,), "ssm.in_proj": (d, 2 * d_in + 2 * gn + h),
             "ssm.conv_w": (s["conv_width"], ch), "ssm.conv_b": (ch,),
             "ssm.A_log": (h,), "ssm.D": (h,), "ssm.dt_bias": (h,),
             "ssm.norm_scale": (d_in,), "ssm.out_proj": (d_in, d)}
    out = {PREFIX + k: (n,) + v for k, v in layer.items()}
    out.update({"tok_embed": (cfg["vocab"], d), "final_norm.scale": (d,)})
    return out


def segsum(x):
    """x (..., T) -> (..., T, T): out[i, j] = x[j+1] + ... + x[i] for
    j <= i, -inf above the diagonal (the paper's stable segsum)."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)
    low = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device), -1)
    x = x.masked_fill(~low, 0.0)
    out = torch.cumsum(x, dim=-2)
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    return out.masked_fill(~keep, -torch.inf)


def ssd(X, A, B, C, chunk):
    """The paper's ``ssd_minimal_discrete``: X (b, l, h, p) = x * dt; A
    (b, l, h) = A * dt; B, C (b, l, h, n). Returns y (b, l, h, p)."""
    b, l, h, p = X.shape
    c = l // chunk
    X = X.reshape(b, c, chunk, h, p)
    B = B.reshape(b, c, chunk, h, -1)
    C = C.reshape(b, c, chunk, h, -1)
    A = A.reshape(b, c, chunk, h).permute(0, 3, 1, 2)          # b h c l
    a_cum = torch.cumsum(A, dim=-1)
    # 1. diagonal blocks
    L = torch.exp(segsum(A))                                   # b h c l s
    CB = torch.einsum("bclhn,bcshn->bhcls", C, B)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", CB * L, X)
    # 2. each chunk's output state
    decay = torch.exp(a_cum[..., -1:] - a_cum)                 # b h c l
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", B, decay, X)
    # 3. the recurrence over chunk boundaries
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    # 4. the carried states' output
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", C, states,
                         torch.exp(a_cum))
    return (y_diag + y_off).reshape(b, l, h, p)


def layer(x, w, cfg, prec):
    """One residual block; ``w`` maps LAYER_KEYS to this layer's tensors."""
    s = cfg["ssm"]
    eps = cfg["norm_eps"]
    d_in, h, gn = dims(cfg)
    bsz, l, _ = x.shape
    u = rmsnorm(x, w["norm1.scale"], eps)
    zxbcdt = prec.mm(u, w["ssm.in_proj"])
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * gn]
    dt = zxbcdt[..., 2 * d_in + 2 * gn:]
    width = s["conv_width"]
    conv = F.conv1d(xbc.transpose(1, 2), w["ssm.conv_w"].T[:, None, :],
                    bias=w["ssm.conv_b"], padding=width - 1,
                    groups=xbc.shape[-1])[..., :l]
    xbc = F.silu(conv.transpose(1, 2))
    xs = xbc[..., :d_in].reshape(bsz, l, h, s["head_dim"])
    rep = h // s["n_groups"]
    Bm = xbc[..., d_in:d_in + gn].reshape(bsz, l, s["n_groups"], -1)
    Cm = xbc[..., d_in + gn:].reshape(bsz, l, s["n_groups"], -1)
    Bm = Bm.repeat_interleave(rep, dim=2)
    Cm = Cm.repeat_interleave(rep, dim=2)
    dt = F.softplus(dt + w["ssm.dt_bias"])                      # b l h
    A = -torch.exp(w["ssm.A_log"])
    y = ssd(xs * dt[..., None], A * dt, Bm, Cm, min(s["chunk"], l))
    y = y + xs * w["ssm.D"][:, None]
    y = y.reshape(bsz, l, d_in)
    y = rmsnorm(y * F.silu(z), w["ssm.norm_scale"], eps)
    return x + prec.mm(y, w["ssm.out_proj"])


def layer_weights(weights, i):
    """Layer i's tensors from the benchmark's stacked weights."""
    return {k: weights[PREFIX + k][i] for k in LAYER_KEYS}


def hidden(weights, tokens, cfg, prec, layer_w=None, remat=False):
    """The final-normed hidden states (b, l, d)."""
    x = weights["tok_embed"][tokens]
    for i in range(cfg["n_layers"]):
        w = layer_w(i) if layer_w else layer_weights(weights, i)
        if remat:
            keys = sorted(w)
            x = checkpoint(
                lambda xx, *ts, keys=keys: layer(xx, dict(zip(keys, ts)),
                                                 cfg, prec),
                x, *(w[k] for k in keys), use_reentrant=False)
        else:
            x = layer(x, w, cfg, prec)
    return rmsnorm(x, weights["final_norm.scale"], cfg["norm_eps"])


def logits(weights, h, prec):
    """Logits of hidden states h (..., d) through the tied embedding."""
    return prec.mm(h, weights["tok_embed"].T)


def last_logits(weights, tokens, cfg, prec=None):
    """Float32 logits at each sequence's last position (b, vocab)."""
    prec = prec or Precision()
    h = hidden(weights, tokens, cfg, prec)
    return logits(weights, h[:, -1], prec)


def all_logits(weights, tokens, cfg, prec=None, rows=1024):
    """Float32 logits at every position (b, l, vocab), the lm head in
    blocks of ``rows`` positions."""
    prec = prec or Precision()
    h = hidden(weights, tokens, cfg, prec)
    return torch.cat([logits(weights, h[:, i:i + rows], prec)
                      for i in range(0, h.shape[1], rows)], dim=1)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------


def layer_params(weights, cfg):
    """Trainable float32 leaves: a list of one dict a layer, and the
    embedding and final norm; each a fresh leaf (a copy of the
    benchmark's weights)."""
    def leaf(t):
        return t.detach().clone().requires_grad_(True)
    layers = [{k: leaf(weights[PREFIX + k][i]) for k in LAYER_KEYS}
              for i in range(cfg["n_layers"])]
    rest = {"tok_embed": leaf(weights["tok_embed"]),
            "final_norm.scale": leaf(weights["final_norm.scale"])}
    return layers, rest


def flat(layers, rest):
    """(path, tensor) of every trainable leaf, layer slices under their
    stacked path (``layers.0.<key>``) in layer order."""
    out = [(PREFIX + k, [lw[k] for lw in layers]) for k in LAYER_KEYS]
    return out + [(k, [v]) for k, v in sorted(rest.items())]


def loss(layers, rest, tokens, labels, cfg, prec, remat=True):
    """Mean next-token cross-entropy of a batch."""
    h = hidden(rest, tokens, cfg, prec, layer_w=lambda i: layers[i],
               remat=remat)
    lg = logits(rest, h, prec)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), labels.reshape(-1))


# --------------------------------------------------------------------------
# operation counts (model FLOPs: recomputation not counted)
# --------------------------------------------------------------------------


def layer_matmul_params(cfg):
    """Weights a token multiplies by in one layer: in_proj (to z, x, B, C,
    dt) and out_proj."""
    d = cfg["d_model"]
    d_in, h, gn = dims(cfg)
    return d * (2 * d_in + 2 * gn + h) + d_in * d


def _ssd(cfg, b, length):
    s = cfg["ssm"]
    d_in, h, _ = dims(cfg)
    return ssd_forward_flops(b, length, h, s["head_dim"], s["n_groups"],
                             s["d_state"], min(s["chunk"], length))


def prefill_flops(cfg, b, length):
    """One prefill of b sequences of ``length`` tokens: 2 a weight a token
    in the projections, the causal depthwise convolution, the SSD forward,
    and the tied lm head at each sequence's last position."""
    s = cfg["ssm"]
    d_in, _, gn = dims(cfg)
    per_token = 2 * layer_matmul_params(cfg) \
        + 2 * s["conv_width"] * (d_in + 2 * gn)
    layer = b * length * per_token + _ssd(cfg, b, length)
    return cfg["n_layers"] * layer + 2 * b * cfg["d_model"] * cfg["vocab"]


def train_flops(cfg, n_params, b, length):
    """One training step of b sequences of ``length`` tokens: 6 a
    parameter a token (the forward and the backward's two products), the
    SSD's terms three times (forward and backward)."""
    return 6 * n_params * b * length + 3 * cfg["n_layers"] * _ssd(
        cfg, b, length)
