"""Plain Mixtral-style decoder (arXiv:2401.04088), float32, prefill only.

Each layer: RMSNorm; grouped-query attention (q heads share kv heads in
groups; rotary positions on q and k over halves of the head, base
``rope_theta``; causal, each query seeing the last ``sliding_window``
keys up to itself; scores scaled by hd^-0.5); the residual; RMSNorm; a
sparse mixture of experts (softmax router over the experts, the top
``top_k`` renormalised, each expert w_o(silu(w_g x) * w_i x)); the
residual. Then a final RMSNorm and an untied lm head.

One departure from the paper, stated by the configuration: an expert
takes at most ``capacity_factor * tokens * top_k / n_experts`` of a
batch's assignments when the batch holds more than 4096 tokens, in the
order of (token, rank) with the earlier kept; the others add nothing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.costs import k5_cost
from portbench.reference.common import Precision, rmsnorm

P = "layers.0."


def param_shapes(cfg):
    """{path: shape} of the model's parameters, each layer's stacked over
    a leading layer axis (the program takes this tree)."""
    d, h, kh, n = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], \
        cfg["n_layers"]
    hd = cfg.get("head_dim") or d // h
    e, f = cfg["moe"]["n_experts"], cfg["moe"]["d_ff_expert"]
    layer = {"norm1.scale": (d,), "norm2.scale": (d,),
             "attn.wq": (d, h, hd), "attn.wk": (d, kh, hd),
             "attn.wv": (d, kh, hd), "attn.wo": (h, hd, d),
             "moe.router": (d, e), "moe.wi": (e, d, f), "moe.wg": (e, d, f),
             "moe.wo": (e, f, d)}
    out = {P + k: (n,) + v for k, v in layer.items()}
    out.update({"tok_embed": (cfg["vocab"], d), "final_norm.scale": (d,),
                "unembed": (d, cfg["vocab"])})
    return out


def rope(x, theta):
    """x (b, l, heads, hd) rotated by its position along l."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(x.shape[1], dtype=torch.float32,
                       device=x.device)[:, None] * inv       # l, hd/2
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(q, k, v, window, block=256):
    """Causal windowed attention, one block of queries at a time: q (b,
    l, h, hd), k and v (b, l, kh, hd) -> (b, l, h, hd)."""
    b, l, h, hd = q.shape
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    out = torch.empty_like(q)
    for s in range(0, l, block):
        e = min(s + block, l)
        lo = max(0, s - window + 1) if window else 0
        qi = torch.arange(s, e, device=q.device)[:, None]
        kj = torch.arange(lo, e, device=q.device)[None, :]
        see = kj <= qi
        if window:
            see = see & (kj > qi - window)
        sc = torch.einsum("bqhd,bkhd->bhqk", q[:, s:e], k[:, lo:e]) \
            * hd ** -0.5
        sc = sc.masked_fill(~see, -torch.inf)
        out[:, s:e] = torch.einsum("bhqk,bkhd->bqhd", sc.softmax(-1),
                                   v[:, lo:e])
    return out


def capacity(moe, tokens):
    if tokens <= 4096:
        return tokens
    return max(int(moe["capacity_factor"] * tokens * moe["top_k"]
                   / moe["n_experts"]), moe["top_k"])


def experts(x, w, i, moe, prec, stats=None):
    """The mixture of experts of layer i on x (t, d). ``stats`` receives,
    under "dropped", each layer's count of assignments over capacity."""
    t = x.shape[0]
    k, n_e = moe["top_k"], moe["n_experts"]
    probs = (x @ w[P + "moe.router"][i]).softmax(-1)
    top, idx = probs.topk(k, dim=-1)
    gate = top / top.sum(-1, keepdim=True)
    flat_e = idx.reshape(-1)                      # (token, rank) order
    rank = torch.cumsum(F.one_hot(flat_e, n_e), dim=0)
    rank = rank.gather(1, flat_e[:, None])[:, 0] - 1
    kept = rank < capacity(moe, t)
    if stats is not None:
        stats.setdefault("dropped", []).append(int((~kept).sum()))
    out = torch.zeros_like(x)
    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    g = gate.reshape(-1)
    for e in range(n_e):
        sel = kept & (flat_e == e)
        rows = tok[sel]
        xe = x[rows]
        he = F.silu(prec.mm(xe, w[P + "moe.wg"][i, e])) \
            * prec.mm(xe, w[P + "moe.wi"][i, e])
        out.index_add_(0, rows, prec.mm(he, w[P + "moe.wo"][i, e])
                       * g[sel][:, None])
    return out


def hidden(w, tokens, cfg, prec, stats=None):
    """The final-normed hidden states (b, l, d). ``stats``, a dict,
    receives under "margin" each sequence's smallest margin, over the
    layers, at its last position between the router's second and third
    expert probabilities (how near that token's top-2 choice is a tie),
    and under "dropped" each layer's assignments over capacity."""
    eps = cfg["norm_eps"]
    d, h, kh = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or d // h
    b, l = tokens.shape
    x = w["tok_embed"][tokens]
    for i in range(cfg["n_layers"]):
        u = rmsnorm(x, w[P + "norm1.scale"][i], eps)
        q = prec.mm(u, w[P + "attn.wq"][i].reshape(d, h * hd))
        kk = prec.mm(u, w[P + "attn.wk"][i].reshape(d, kh * hd))
        vv = prec.mm(u, w[P + "attn.wv"][i].reshape(d, kh * hd))
        q = rope(q.reshape(b, l, h, hd), cfg["rope_theta"])
        kk = rope(kk.reshape(b, l, kh, hd), cfg["rope_theta"])
        o = attention(q, kk, vv.reshape(b, l, kh, hd),
                      cfg["sliding_window"])
        x = x + prec.mm(o.reshape(b, l, h * hd),
                        w[P + "attn.wo"][i].reshape(h * hd, d))
        del q, kk, vv, o
        u = rmsnorm(x, w[P + "norm2.scale"][i], eps)
        if stats is not None:
            p = (u[:, -1] @ w[P + "moe.router"][i]).softmax(-1)
            p = p.sort(dim=-1, descending=True).values
            m = p[:, cfg["moe"]["top_k"] - 1] - p[:, cfg["moe"]["top_k"]]
            stats["margin"] = m if "margin" not in stats \
                else torch.minimum(stats["margin"], m)
        x = x + experts(u.reshape(b * l, d), w, i, cfg["moe"],
                        prec, stats).reshape(b, l, d)
    return rmsnorm(x, w["final_norm.scale"], eps)


def last_logits(w, tokens, cfg, prec=None, stats=None):
    """Float32 logits at each sequence's last position (b, vocab)."""
    prec = prec or Precision()
    return prec.mm(hidden(w, tokens, cfg, prec, stats)[:, -1], w["unembed"])


def all_logits(w, tokens, cfg, prec=None, rows=1024):
    """Float32 logits at every position (b, l, vocab), in blocks."""
    prec = prec or Precision()
    h = hidden(w, tokens, cfg, prec)
    return torch.cat([prec.mm(h[:, i:i + rows], w["unembed"])
                      for i in range(0, h.shape[1], rows)], dim=1)


def prefill_flops(cfg, b, length):
    """Model operations of one prefill: the q, k, v and o projections, the
    router, top-k experts of three products each, the attention band (K5's
    operations), and the lm head at each sequence's last position."""
    d, h, kh = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or d // h
    m = cfg["moe"]
    proj = 2 * 2 * d * h * hd + 2 * 2 * d * kh * hd      # q, o; k, v
    experts_ = m["top_k"] * 3 * 2 * d * m["d_ff_expert"]
    router = 2 * d * m["n_experts"]
    attn, _ = k5_cost(b, length, h, kh, hd, cfg["sliding_window"], 2)
    layer = b * length * (proj + experts_ + router) + attn
    return cfg["n_layers"] * layer + 2 * b * d * cfg["vocab"]
