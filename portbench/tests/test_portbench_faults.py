"""The comparison catches a broken timed path: each fault a cell can
have, planted under the harness at a tiny size on the CPU, makes
``correct`` false; so does the control (the reference in float8 in the
program's place), and a state the program leaves unchanged."""
import pytest
import torch

from portbench.tests.tiny import run_tiny


def _wrap_local(monkeypatch, change):
    from repro_torch.core import hierarchy as H
    make = H.make_hfl_local_step

    def broken(cfg, opt_cfg):
        local = make(cfg, opt_cfg)
        return lambda state, batches: change(local, state, batches)
    monkeypatch.setattr(H, "make_hfl_local_step", broken)


def test_state_left_unchanged(monkeypatch):
    def unchanged(local, state, batches):
        import copy
        keep = copy.deepcopy(state)
        _, m = local(state, batches)
        for a, b in zip(torch.utils._pytree.tree_leaves(state),
                        torch.utils._pytree.tree_leaves(keep)):
            a.copy_(b)
        return state, m
    _wrap_local(monkeypatch, unchanged)
    r = run_tiny("train")
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] > 0.9


def test_half_the_batch_left_out(monkeypatch):
    def half(local, state, batches):
        cut = [{k: v[: v.shape[0] // 2] for k, v in b.items()}
               for b in batches]
        return local(state, cut)
    _wrap_local(monkeypatch, half)
    r = run_tiny("train")
    assert not r["correct"]


def test_exchange_left_out(monkeypatch):
    from repro_torch.core import hierarchy as H
    monkeypatch.setattr(H, "make_cluster_sync",
                        lambda cfg, **kw: (lambda state: state))
    r = run_tiny("train")
    assert not r["correct"]
    assert r["checks"]["sync_gap"]["value"] > 0.1


def _alter_logits(monkeypatch, change):
    from repro_torch.models import model as M
    prefill = M.prefill

    def altered(params, cfg, batch):
        logits, cache = prefill(params, cfg, batch)
        return change(logits.clone()), cache
    monkeypatch.setattr(M, "prefill", altered)


@pytest.mark.parametrize("which", ["moe_prefill", "ssm_prefill"])
def test_answer_altered_where_produced(monkeypatch, which):
    # each request's last-position logits shifted by one vocabulary entry
    def roll(out):
        out[:, -1] = out[:, -1].roll(1, dims=-1)
        return out
    _alter_logits(monkeypatch, roll)
    r = run_tiny(which)
    assert not r["correct"]
    assert r["checks"]["logit_err"]["value"] > \
        r["checks"]["logit_err"]["limit"]


def test_token_altered_where_produced(monkeypatch):
    """Where the served token is compared (mamba2's prefill; mixtral's
    token gap has no upper reading), a token made first that the logits
    do not favour is caught."""
    def least_first(out):
        last = out[:, -1]
        worst = last.argmin(dim=-1, keepdim=True)
        last.scatter_(1, worst, last.max(dim=-1, keepdim=True).values + 1)
        return out
    _alter_logits(monkeypatch, least_first)
    r = run_tiny("ssm_prefill")
    assert not r["correct"]
    assert r["checks"]["token_gap"]["value"] > \
        r["checks"]["token_gap"]["limit"]


@pytest.mark.parametrize("which", ["moe_prefill", "ssm_prefill"])
def test_one_slot_of_each_batch_altered(monkeypatch, which):
    """A fault in one slot of every batch of 4 (the last sequence's logits
    shifted by one vocabulary entry) is caught, though it leaves three
    requests in four right and the median over all of them where it
    was."""
    def last_slot(out):
        out[-1, -1] = out[-1, -1].roll(1, dims=-1)
        return out
    _alter_logits(monkeypatch, last_slot)
    r = run_tiny(which, batch=4)
    assert not r["correct"]
    row = r["checks"]["slot_logit_err"]
    assert row["value"] > row["limit"]
    row = r["checks"]["logit_err"]
    assert row["value"] <= row["limit"]
