"""Traffic kind "hfl_train": AutoFLSat's two-tier training.

``clusters`` orbital clusters each hold their own replica of the model
and its AdamW state on the card. A tier-1 step trains every cluster on
its own batch of ``batch`` x ``seq`` tokens
(``core/hierarchy.py::make_hfl_local_step``); after every
``sync_every``-th step the tier-2 exchange averages parameters and moments
over the clusters, the parameters quantized to ``quant_bits`` bits
(``make_cluster_sync``, QuAFL). One round is ``sync_every`` tier-1 steps
and one sync.

Set-up builds the state from the seed and runs the first round through
the window's own calls and feed, reading on the way what the check needs
(each step's loss; the first gradient, as AdamW's first moment holds it;
the parameters' change after ``checked_steps`` steps). The window starts
at a round boundary on a drained device and runs whole rounds until the
first boundary at or after its seconds; nothing in it waits for the
device or reads a device value on the host. Then one synchronisation
ends it, and the rate is all its tokens over all its time.
"""
from __future__ import annotations

import time

import torch

from repro_torch.core import hierarchy as H
from repro_torch.optim.optimizers import AdamWConfig
from repro_torch.train.steps import TrainState

from portbench import checks
from portbench import weights as W
from portbench.harness import say
from portbench.reference import optim as RO
from portbench.reference.common import Precision, exact_float32


class Feed:
    """Each cluster's token stream: rows uniform over the vocabulary,
    drawn on the device from a generator seeded by the run's seed and the
    cluster, so every row differs and the same seed gives the same
    stream."""

    def __init__(self, seed, clusters, batch, seq, vocab, device):
        self.shape, self.vocab, self.device = (batch, seq + 1), vocab, device
        self.gens = [torch.Generator(device=device).manual_seed(
            W.leaf_seed(seed, f"feed.{c}")) for c in range(clusters)]

    def next(self):
        out = []
        for g in self.gens:
            t = torch.randint(0, self.vocab, self.shape, generator=g,
                              device=self.device)
            out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
        return out


class Trainer:
    """The program's training object: state, tier-1 step, tier-2 sync and
    feed, built from the seed."""

    def __init__(self, env, seed=None):
        seed = env.seed if seed is None else seed
        tr = env.traffic
        self.env, self.seed = env, seed
        self.cfg = env.program_config("train")
        self.nc = tr["clusters"]
        self.shapes = env.reference().param_shapes(env.config)
        w = W.make(torch, env.config["init"], self.shapes, seed, env.device,
                   lead=(self.nc,))
        self.p = w
        self.m = {p: torch.zeros_like(t) for p, t in w.items()}
        self.v = {p: torch.zeros_like(t) for p, t in w.items()}
        opt = {"m": W.tree(self.m), "v": W.tree(self.v),
               "step": torch.zeros((self.nc,), dtype=torch.int32,
                                   device=env.device)}
        self.state = TrainState(params=W.tree(w), opt=opt)
        self.hp = tr["adamw"]
        self.local = H.make_hfl_local_step(self.cfg, AdamWConfig(**self.hp))
        self.sync = H.make_cluster_sync(self.cfg, quant_bits=tr["quant_bits"])
        self.feed = Feed(seed, self.nc, tr["batch"], tr["seq"],
                         self.cfg.vocab, env.device)
        self.n_params = sum(t[0].numel() for t in w.values())

    def first_round(self):
        """Round one, as in the window, reading on the device what the
        check needs. Returns the readings (device tensors)."""
        tr = self.env.traffic
        losses, grad, change = [], None, None
        for i in range(tr["sync_every"]):
            self.state, met = self.local(self.state, self.feed.next())
            losses.append(met["loss"])
            if i == 0:
                # AdamW's first moment after one step is (1 - b1) times
                # the clipped gradient
                grad = {p: [W.layer_norms(torch, m[c], p) / (1 - self.hp["b1"])
                            for c in range(self.nc)]
                        for p, m in self.m.items()}
            if i + 1 == tr["checked_steps"]:
                change = self.change_norms()
        self.state = self.sync(self.state)
        return {"loss": torch.stack(losses[:tr["checked_steps"]]),
                "grad": grad, "change": change}

    def change_norms(self):
        """Each leaf's norm of its change from the weights the seed gave,
        each leaf drawn again alone."""
        out = {}
        for path, shape in self.shapes.items():
            p0 = W.draw(torch, W.rule_for(self.env.config["init"], path),
                        tuple(shape), self.seed, path, self.env.device)
            out[path] = [W.layer_norms(torch, self.p[path][c] - p0, path)
                         for c in range(self.nc)]
            del p0
        return out

    def sync_check(self, sync=None):
        """One more tier-1 step, so that the clusters differ, then the
        tier-2 sync against the reference's average of the same state.
        Returns the worst leaf's distance from it (over the larger of its
        norm and the median leaf's, per group: parameters, moments)."""
        bits = self.env.traffic["quant_bits"]
        self.state, _ = self.local(self.state, self.feed.next())
        groups = {"params": (self.p, lambda x: RO.quantized_mean(x, bits)),
                  "m": (self.m, RO.mean), "v": (self.v, RO.mean)}
        with exact_float32():
            want = {g: {p: f(x) for p, x in leaves.items()}
                    for g, (leaves, f) in groups.items()}
        self.state = (sync or self.sync)(self.state)
        worst = 0.0
        for g, (leaves, _) in groups.items():
            ref = {p: W.layer_norms(torch, want[g][p], p).tolist()
                   for p in leaves}
            for c in range(self.nc):
                diff = {p: W.layer_norms(torch, leaves[p][c] - want[g][p],
                                         p).tolist() for p in leaves}
                worst = max(worst, checks.worst_rel_diff(diff, ref))
        del want
        return worst


def host(readings, nc):
    """The first round's readings on the host: losses (steps x clusters),
    and a dict of each leaf's norms a cluster."""
    def per(d):
        return [{p: v[c].tolist() for p, v in d.items()} for c in range(nc)]
    return {"loss": readings["loss"].tolist(), "grad": per(readings["grad"]),
            "change": per(readings["change"])}


def reference(env, seed, precision="float32", fault=None):
    """The plain reference's readings for the first ``checked_steps``
    steps of every cluster, from the seed's weights and feed: losses
    (steps x clusters), each leaf's clipped first gradient norm and its
    change. ``fault`` "half_batch" trains on the first half of each batch
    (a planted fault)."""
    R = env.reference()
    tr, cfg = env.traffic, env.config
    nc, steps = tr["clusters"], tr["checked_steps"]
    prec = Precision(precision)
    w = W.make(torch, cfg["init"], R.param_shapes(cfg), seed, env.device)
    feed = Feed(seed, nc, tr["batch"], tr["seq"], cfg["vocab"], env.device)
    batches = [feed.next() for _ in range(steps)]
    losses = [[None] * nc for _ in range(steps)]
    grads, changes = [], []
    with exact_float32():
        for c in range(nc):
            layers, rest = R.layer_params(w, cfg)
            leaves = R.flat(layers, rest)
            params = [t for _, ts in leaves for t in ts]
            opt = RO.AdamW(params, tr["adamw"])
            for s in range(steps):
                b = batches[s][c]
                tok, lab = b["tokens"], b["labels"]
                if fault == "half_batch":
                    tok, lab = tok[:tok.shape[0] // 2], lab[:lab.shape[0] // 2]
                loss = R.loss(layers, rest, tok, lab, cfg, prec)
                g = torch.autograd.grad(loss, params)
                g, _ = RO.clip_by_global_norm(g, tr["adamw"]["grad_clip"])
                if s == 0:
                    it = iter(g)
                    grads.append({p: [float(next(it).norm()) for _ in ts]
                                  for p, ts in leaves})
                opt.step(g)
                losses[s][c] = float(loss.detach())
                del g, loss
            changes.append({p: [float((t.detach() - w[p][i]).norm())
                                if W.stacked(p) else
                                float((t.detach() - w[p]).norm())
                                for i, t in enumerate(ts)]
                            for p, ts in leaves})
            del layers, rest, leaves, params, opt
            env.free()
    return {"loss": losses, "grad": grads, "change": changes}


def numbers(prog, ref, where=None):
    """The cell's numbers but the sync's. ``grad_gap``: the median leaf's
    gap between the program's and the reference's norm of the first
    (clipped) gradient; ``change_gap``: the worst leaf's gap of the norm of
    the parameters' change, over the leaves the reference's gradient moves
    (``checks``). ``where`` (a dict) receives the worst leaves and the
    losses' worst relative gap, which are reported, not compared."""
    grad = max(checks.median_norm_gap(p, r)
               for p, r in zip(prog["grad"], ref["grad"]))
    wc = []
    change = max(checks.worst_norm_gap(p, r, keep=checks.moved_leaves(g),
                                       where=wc)
                 for p, r, g in zip(prog["change"], ref["change"],
                                    ref["grad"]))
    if where is not None:
        wg = []
        for p, r in zip(prog["grad"], ref["grad"]):
            checks.worst_norm_gap(p, r, where=wg)
        lp = [x for row in prog["loss"] for x in row]
        lr = [x for row in ref["loss"] for x in row]
        where.update(grad_worst=max(wg), change_worst=max(wc),
                     loss_gap=checks.worst_rel_gap(lp, lr))
    return {"grad_gap": grad, "change_gap": change}


def run(env):
    tr = env.traffic
    env.load_kernels("train")
    t = Trainer(env)
    env.mark("weights")
    first = t.first_round()
    spans = env.spans
    t_start = env.start_window()
    losses, rounds = [], 0
    while True:
        for _ in range(tr["sync_every"]):
            batches = t.feed.next()
            with spans("portbench::tier1"):
                t.state, met = t.local(t.state, batches)
            losses.append(met["loss"])
        with spans("portbench::sync"):
            t.state = t.sync(t.state)
        rounds += 1
        if time.perf_counter() - t_start >= env.window_seconds:
            break
    t_end = env.end_window()
    wall = t_end - t_start
    steps = rounds * tr["sync_every"]
    tokens = steps * t.nc * tr["batch"] * tr["seq"]
    finite = torch.isfinite(torch.stack(losses)).all(dim=1)
    failed = int((~finite).sum())
    prog = host(first, t.nc)
    n_params = t.n_params

    t0 = time.perf_counter()
    sync_gap = t.sync_check()
    del t
    env.free()
    ref = reference(env, env.seed)
    say(f"window: {rounds} rounds, {steps} tier-1 steps in {wall:.3f} s; "
        f"check {time.perf_counter() - t0:.1f} s")
    where = {}
    nums = dict(numbers(prog, ref, where), sync_gap=sync_gap)
    say(f"not compared (gap, path, layer, program, reference, median): "
        f"{where}")
    R = env.reference()
    step_flops = R.train_flops(env.config, n_params, tr["batch"],
                               tr["seq"]) * tr["clusters"]
    return {
        "end_to_end": {"train_tokens_per_s": tokens / wall},
        "numbers": nums, "attempted": steps, "failed": failed,
        "spans": {k: env.spans.ms(k) for k in ("portbench::tier1",
                                               "portbench::sync")},
        "counts": {"wall_s": wall, "steps": steps, "syncs": rounds,
                   "tokens": tokens, "step_flops": step_flops,
                   "flops": step_flops * steps},
    }

