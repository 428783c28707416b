"""A run with its timed path broken underneath comes out not correct: the
whole run but the look for a card, at tiny sizes on the CPU, with the
cells' own limits.  The faults a fleet of one chip can have: an iteration
that returns its state unchanged, half of the batch left out (those lanes
given the other lanes' answers), and an answer altered where it is
produced.  (No cell spans chips, so none can leave an exchange out.)"""

import dataclasses

import pytest
import torch

from lpbench.tests import tiny


def _par():
    import cholesky_is_magic_tpu_torch.parallel as par

    return par


def test_sound_runs_are_correct(tmp_path):
    root = tiny.make_tiny_root(tmp_path)
    for workload in ("pds-10.fleet64", "pilot.batch128"):
        line = tiny.run(root, workload, 0)["line"]
        assert line["correct"] is True, (workload, line["checks"])


def test_a_step_that_returns_its_state_unchanged(tmp_path, monkeypatch):
    import importlib

    # The solvers package re-exports a function named pdas: reach the module.
    pdas = importlib.import_module("cholesky_is_magic_tpu_torch.solvers.pdas")
    real = pdas._one_iteration

    def unchanged(st, *args, **kwargs):
        _, gap, pviol, step, ok = real(st, *args, **kwargs)
        return st, gap, pviol, step, ok

    monkeypatch.setattr(pdas, "_one_iteration", unchanged)
    line = tiny.run(tiny.make_tiny_root(tmp_path), "pds-10.fleet64", 0)["line"]
    assert line["correct"] is False and line["failed"] == line["attempted"]


def _broken(monkeypatch, name, breaker):
    par = _par()
    real = getattr(par, name)

    def broken(states, cfg, engine=None):
        return breaker(real, states, cfg, engine)

    monkeypatch.setattr(par, name, broken)


def _half(real, states, cfg, engine):
    """Solve the first half of the lanes; the rest get those lanes' answers."""
    from cholesky_is_magic_tpu_torch.utils import lanes

    leaves, build = lanes.flatten(states)
    B = leaves[0].shape[0]
    h = (B + 1) // 2
    res = real(build([t[:h] for t in leaves]), cfg, engine=engine)
    idx = torch.arange(B) % h
    r_leaves, r_build = lanes.flatten(res)
    return r_build([t[idx.to(t.device)] if t.dim() and t.shape[0] == h else t
                    for t in r_leaves])


def _altered(real, states, cfg, engine):
    """Lane 1's x moved by a thousandth of the largest |x| in one entry."""
    res = real(states, cfg, engine=engine)
    x = res.x.clone()
    x[1, 5] += 1e-3 * (1 + x[1].abs().max())
    return dataclasses.replace(res, x=x)


@pytest.mark.parametrize("workload,name", [("pds-10.fleet64", "batched_pdas"),
                                           ("pilot.batch128", "batched_pdas_dd")])
@pytest.mark.parametrize("breaker", [_half, _altered], ids=["half_the_batch", "altered"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, workload, name, breaker):
    _broken(monkeypatch, name, breaker)
    line = tiny.run(tiny.make_tiny_root(tmp_path), workload, 0)["line"]
    assert line["correct"] is False, line["checks"]
