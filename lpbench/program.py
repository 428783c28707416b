"""What the entries share of the program: its modules by name, the wait
for the card, the lanes as the program's ``StandardForm``s, a phase's
``PDASConfig`` and a batched solve's result as host arrays.

Nothing here runs at import: the program is imported when an entry first
asks for one of its modules.
"""

from __future__ import annotations

import importlib

import numpy as np


def mod(name: str):
    """The port's module ``cholesky_is_magic_tpu_torch.<name>``."""
    return importlib.import_module(f"cholesky_is_magic_tpu_torch.{name}")


def sync(device: str) -> None:
    """Wait for the card (nothing on the CPU)."""
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def standard_forms(fleet) -> list:
    """Each lane of the fleet as the program's StandardForm (equality rows)."""
    sf_cls = mod("ingest.standard_form").StandardForm
    f = fleet
    return [sf_cls(nvars=f.n, ncons=f.m, c=f.c[k].copy(),
                   a_rows=f.rows.astype(np.int32), a_cols=f.cols.astype(np.int32),
                   a_vals=f.vals.copy(), b=f.b[k].copy(),
                   row_type=np.zeros(f.m, np.int8), l=f.l.copy(), u=f.u.copy(),
                   initial_vars=f.n_struct)
            for k in range(f.lanes)]


def pdas_config(phase: dict, cap: int | None):
    """The phase's ``PDASConfig``; ``cap``: at most that many iterations."""
    kw = dict(phase.get("config", {}))
    if cap is not None:
        kw["max_iters"] = min(cap, kw.get("max_iters", cap))
    return mod("solvers.pdas").PDASConfig(**kw)


def pdas_host(r) -> dict:
    """A batched pdas or pdas_dd result as the host arrays the check and
    the counters read: ``status``, ``iterations``, ``x``, ``objective``,
    ``gap`` and, where the solver returns them, ``y``, ``w``, ``z``,
    ``x_lo`` (axis 0 the lanes)."""
    host = {"status": r.status.cpu().numpy(), "iterations": r.iterations.cpu().numpy(),
            "x": r.x.cpu().numpy(), "objective": r.objective.cpu().numpy(),
            "gap": r.extra["gap"].cpu().numpy()}
    for key in ("y", "w", "z", "x_lo"):
        if key in r.extra:
            host[key] = r.extra[key].cpu().numpy()
    return host


def optimal_status() -> int:
    """The program's status code of a solve that met its stop."""
    return int(mod("solvers.result").Status.OPTIMAL)
