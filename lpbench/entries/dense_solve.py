"""One LP solved alone on the dense padded path, as ``api.solve(...,
"pdas_dd")`` solves it: in set-up the fleet's lane 0 moved to the card
(``ingest.device.to_device_lp``); a call runs the traffic's phases in
turn, the first ``pdas`` from the solver's own initial point
(``make_pdas`` → ``pdas``), each later phase started from the one before
it: ``make_pdas_dd(warm=)`` → ``pdas_dd`` for the double-word finisher,
``make_pdas(warm=)`` → ``pdas`` for a float32 phase (the control runs
that in the finisher's place).  Each phase takes the configuration's
settings.

Traffic parameters: ``pad_multiple`` (the padded box).  The traffic has
one lane.
"""

import numpy as np

from lpbench.program import mod, pdas_config, pdas_host, standard_forms

OPERANDS = "dense"


def host(r) -> dict:
    """One phase's result as host arrays with a lane axis of one."""
    return {k: np.asarray(v)[None] for k, v in pdas_host(r).items()}


def setup(drv):
    """The LP on the card (``DeviceLP``)."""
    if drv.lanes != 1:
        raise ValueError("dense_solve solves one lane")
    return mod("ingest.device").to_device_lp(
        standard_forms(drv.fleet)[0], pad_multiple=drv.traffic["pad_multiple"],
        dtype=drv.dtype, device=drv.device)


def call(drv, lp, cap):
    """Each phase once; the phases' results in order."""
    pdas, pdas_dd = mod("solvers.pdas"), mod("solvers.pdas_dd")
    results, prev = [], None
    for phase in drv.phases:
        cfg = pdas_config(phase, cap)
        if prev is None:
            prev = pdas.pdas(pdas.make_pdas(lp, cfg), cfg)
        elif phase["solver"] == "pdas_dd":
            prev = pdas_dd.pdas_dd(pdas_dd.make_pdas_dd(lp, warm=prev), cfg)
        else:
            warm = pdas.PDASState(x=prev.x, y=prev.extra["y"], w=prev.extra["w"],
                                  z=prev.extra["z"], lp=None)
            prev = pdas.pdas(pdas.make_pdas(lp, cfg, warm=warm), cfg)
        results.append(prev)
    return results
