"""The one driver every cell runs: a fleet of LPs drawn by the
configuration's generator, handed to the program by the traffic's entry,
call after call.

A configuration file (``configs/<config>.json``) says how to make the
LP (``generator``: ``gen/<generator>.py``, and its sizes), its ``dtype``
and the solver settings of each phase (``phases``).  A traffic file
(``traffic/<traffic>.json``) names the entry that hands the lanes to the
program (``entry``: ``entries/<entry>.py``, with its own parameters beside
it), how many lanes a call solves (``lanes``), which phases it runs in
which order (``phases``), and how calls arrive (``loop``: ``"closed"``
with ``clients`` 1, the next call once the last has returned).  Every
call is cold: each lane starts from the solver's own initial point, so
every call does the same work.

An entry module has ``OPERANDS`` (how the program holds the LP, for
:func:`lpbench.reference.check.program_operands`), ``setup(drv)`` (the
program's state), ``call(drv, state, cap)`` (the phases' results, on the
device) and ``host(result)`` (one phase's result as host arrays, axis 0
the lanes: ``status``, ``iterations``, ``x``, ``objective``, ``gap``,
``y``, ``z``, ``w`` and, where the solver returns it, ``x_lo``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import sys
import time
from pathlib import Path

import numpy as np

from lpbench import program

HERE = Path(__file__).resolve().parent


def load(root: Path, sub: str, name: str):
    """The module ``<root>/<sub>/<name>.py`` (the name may hold dots and
    dashes)."""
    path = root / sub / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{sub}/{name}.py is missing under {root}")
    key = f"lpbench_{sub}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod  # a dataclass in the module looks itself up there
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Call:
    """One call: its host-clock seconds and, per phase, the entry's result
    (on the device until :meth:`Driver.to_host`)."""

    seconds: float
    results: list


class Driver:
    """Set-up and calls of one cell (see the module docstring)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str,
                 root: Path = HERE):
        import torch

        loop = traffic.get("loop", "closed")
        if loop != "closed" or traffic.get("clients", 1) != 1:
            raise ValueError(f"traffic: only a closed loop of one client runs, got"
                             f" {loop!r} with {traffic.get('clients')} clients")
        self.config, self.traffic, self.device = config, traffic, device
        self.dtype = getattr(torch, config.get("dtype", "float32"))
        self.phases = [dict(config["phases"][p], name=p) for p in traffic["phases"]]
        self.lanes = int(traffic["lanes"])
        self.entry = load(root, "entries", traffic["entry"])
        self.path = self.entry.OPERANDS
        self.fleet = load(root, "gen", config["generator"]).make(config, seed, self.lanes)
        self.state = None

    def setup(self) -> None:
        self.state = self.entry.setup(self)

    def release(self) -> None:
        """Drop the program's state (before the reference runs)."""
        self.state = None

    def call(self, cap: int | None = None) -> Call:
        """Every phase of the traffic once over all lanes; synchronized at
        both ends.  ``cap``: at most that many iterations a phase (every
        iteration has the same shapes, so one a phase runs every kernel and
        shape of a whole call)."""
        program.sync(self.device)
        t = time.perf_counter()
        results = self.entry.call(self, self.state, cap)
        program.sync(self.device)
        return Call(seconds=time.perf_counter() - t, results=results)

    def to_host(self, call: Call) -> None:
        """Replace each phase's result by the entry's host arrays."""
        call.results = [r if isinstance(r, dict) else self.entry.host(r)
                        for r in call.results]

    def iterates(self, call: Call) -> list:
        """Each lane's returned iterate of the call's last phase."""
        r = call.results[-1]
        return [{"x": r["x"][k], "x_lo": r["x_lo"][k] if "x_lo" in r else None,
                 "y": r["y"][k], "z": r["z"][k], "w": r["w"][k],
                 "objective": float(r["objective"][k])} for k in range(self.lanes)]

    @staticmethod
    def stopped(call: Call) -> int:
        """Lanes whose last phase met its stop (status optimal)."""
        return int(np.sum(call.results[-1]["status"] == program.optimal_status()))

    @staticmethod
    def loop_iterations(call: Call) -> int:
        """Iterations the batched loops ran: the slowest lane's, summed
        over the phases."""
        return int(sum(int(np.max(r["iterations"])) for r in call.results))
