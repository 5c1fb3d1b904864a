"""Traffic kind "prefill": one client sends batches of ``batch`` prompts of
``prompt_len`` tokens back to back (a closed loop) and waits for each
batch's first tokens on the host.

A call is the serving path's prefill (``models/model.py::prefill``, as
``launch/serve.py::generate`` calls it, under ``torch.inference_mode``)
and the greedy first token of each prompt, read on the host. Each prompt
is one request; its time to first token runs from the call's dispatch to
that read. Prompts are uniform over the vocabulary, drawn on the device
from the seed (warm-up prompts from a stream of their own, so the
window's prompts do not depend on the warm-up).

A sample of ``check_calls`` of the window's calls, drawn from the seed
by reservoir sampling as the calls finish, is kept on the device; the
rest are freed at once, so that what the benchmark holds stays the same
however many calls the window makes (``peak_gib`` measures the program).
After the window the sample runs through the plain reference: each
served token's gap below the reference's best logit, and the distance of
the program's last-position logits from the reference's.
"""
from __future__ import annotations

import math
import random
import time

import torch

from repro_torch.models import model as M

from portbench import weights as W
from portbench.checks import median
from portbench.harness import say
from portbench.reference.common import Precision, exact_float32


class Server:
    """The program's serving path with the seed's weights."""

    def __init__(self, env, seed=None):
        seed = env.seed if seed is None else seed
        tr = env.traffic
        self.env, self.seed = env, seed
        self.cfg = env.program_config("prefill")
        self.w = W.make(torch, env.config["init"],
                        env.reference().param_shapes(env.config), seed,
                        env.device)
        self.params = W.tree(self.w)
        self.shape = (tr["batch"], tr["prompt_len"])
        self.prompts = torch.Generator(device=env.device).manual_seed(
            W.leaf_seed(seed, "prompts"))
        self.warm_prompts = torch.Generator(device=env.device).manual_seed(
            W.leaf_seed(seed, "warmup_prompts"))

    def draw(self, gen=None):
        return torch.randint(0, self.cfg.vocab, self.shape,
                             generator=gen or self.prompts,
                             device=self.env.device)

    @torch.inference_mode()
    def call(self, tokens):
        """(last-position logits (b, vocab) float32, greedy first tokens)."""
        logits, _ = M.prefill(self.params, self.cfg, {"tokens": tokens})
        last = logits[:, -1, :]
        return last, torch.argmax(last, dim=-1)


def percentile(values, q):
    """The q-th percentile by nearest rank: the smallest value with at
    least q% of the values at or below it."""
    v = sorted(values)
    k = max(1, -(-len(v) * q // 100))
    return v[int(k) - 1]


def gaps(ref_logits, served):
    """Each row's gap of its served token's logit below the reference's
    best (a list)."""
    ref = ref_logits.to(torch.float32)
    best = ref.max(dim=-1).values
    got = ref.gather(1, served[:, None].to(torch.int64))[:, 0]
    return (best - got).tolist()


def errors(ref_logits, prog_logits):
    """Each row's relative L2 distance of the program's logits from the
    reference's (a list)."""
    ref = ref_logits.to(torch.float32)
    return ((prog_logits.to(torch.float32) - ref).norm(dim=-1)
            / ref.norm(dim=-1)).tolist()


def numbers(gap_list, err_list, batch, keep=None):
    """The cell's numbers over its checked requests, given call by call
    (``batch`` requests a call, in slot order): ``token_gap``, the widest
    gap of a served token below the reference's best logit;
    ``logit_err``, the median request's relative L2 distance of the
    last-position logits (a median: an expert choice that a near-tie, at
    any position, sends the other way under rounding moves one request's
    logits by tens of percent); ``slot_logit_err``, the same median taken
    over the calls for each slot of the batch, the worst slot's (a fault
    in one slot of every batch moves its slot's median, where the median
    over all requests would not see it). ``keep``, one flag a request,
    leaves requests at a near-tie out of the slots' medians (see
    ``near_ties``)."""
    keep = keep or [True] * len(gap_list)
    slots = [[e for e, k in zip(err_list[i::batch], keep[i::batch]) if k]
             for i in range(batch)]
    return {"token_gap": max(gap_list), "logit_err": median(err_list),
            "slot_logit_err": max((median(v) for v in slots if v),
                                  default=math.inf)}


def near_ties(env, margins, n):
    """``n`` flags, one a request: False where the limits file sets
    ``near_tie_margin`` and the reference's router, at the request's last
    position and in some layer, puts its last chosen expert within that
    margin of the next (a choice that rounding may send the other way)."""
    floor = env.spec["limits"].get("near_tie_margin")
    if floor is None or margins is None:
        return [True] * n
    return [float(m) >= floor for m in margins]


class Sample:
    """A uniform sample of ``k`` of a stream of calls, drawn from ``seed``
    (reservoir sampling): at most ``k`` calls are held at any time."""

    def __init__(self, k, seed):
        self.k, self.rng, self.seen, self.kept = k, random.Random(seed), 0, []

    def offer(self, call):
        if len(self.kept) < self.k:
            self.kept.append(call)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.kept[j] = call
        self.seen += 1


def check(env, s, calls):
    """(gaps, errors, keep) of the calls ``calls`` [(tokens, last logits,
    first tokens)] against the plain reference, call by call."""
    gap_list, err_list, keep = [], [], []
    for tokens, last, first in calls:
        stats = {}
        ref = reference_logits(env, s.w, tokens, stats=stats)
        gap_list += gaps(ref, first)
        err_list += errors(ref, last)
        keep += near_ties(env, stats.get("margin"), len(first))
        del ref
    return gap_list, err_list, keep


def reference_logits(env, w, tokens, precision="float32", every=False,
                     stats=None):
    """The reference's logits at the last positions (or ``every``
    position); ``stats``, a dict, receives a mixture-of-experts
    reference's router margins (see ``reference/mixtral.py``)."""
    R = env.reference()
    kw = {"stats": stats} if stats is not None and \
        env.config["arch_type"] == "moe" and not every else {}
    with exact_float32(), torch.no_grad():
        f = R.all_logits if every else R.last_logits
        return f(w, tokens, env.config, Precision(precision), **kw)


def run(env):
    tr = env.traffic
    env.load_kernels("prefill")
    s = Server(env)
    env.mark("weights")
    for _ in range(tr["warmup_calls"]):
        s.call(s.draw(s.warm_prompts))[1].tolist()
    spans = env.spans
    sample = Sample(tr["check_calls"], env.seed)
    ttft = []
    vocab = s.cfg.vocab
    bad = torch.zeros((), dtype=torch.int64, device=env.device)
    t_start = env.start_window()
    while True:
        tokens = s.draw()
        t0 = time.perf_counter()
        with spans("portbench::prefill"):
            last, first = s.call(tokens)
            served = first.tolist()          # the first tokens on the host
        t1 = time.perf_counter()
        ttft.extend([t1 - t0] * len(served))
        # rows with a non-finite logit and tokens out of the vocabulary,
        # counted on the device and read after the window
        bad += (~torch.isfinite(last).all(dim=-1)).sum() \
            + ((first < 0) | (first >= vocab)).sum()
        sample.offer((tokens, last, first))
        del tokens, last, first
        if t1 - t_start >= env.window_seconds:
            break
    t_end = env.end_window()
    wall = t_end - t_start
    failed = int(bad)
    calls = sample.seen

    t_check = time.perf_counter()
    gap_list, err_list, keep = check(env, s, sample.kept)
    say(f"window: {calls} calls in {wall:.3f} s; check of "
        f"{len(sample.kept)} calls {time.perf_counter() - t_check:.1f} s")
    b, plen = s.shape
    flops = env.reference().prefill_flops(env.config, b, plen)
    return {
        "end_to_end": {"ttft_p95_s": percentile(ttft, 95)},
        "numbers": numbers(gap_list, err_list, s.shape[0], keep),
        "attempted": len(ttft), "failed": failed,
        "spans": {"portbench::prefill": env.spans.ms("portbench::prefill")},
        "counts": {"wall_s": wall, "calls": calls, "requests": len(ttft),
                   "call_flops": flops, "flops": flops * calls,
                   "batch": b, "prompt_len": plen},
    }
