"""The fully sparse fleet on one tile engine: in set-up lane 0's state and
the engine (``make_pdas_sparse``), every other lane's state on that
engine, all stacked (``parallel.stack_sparse_states``); a call runs one
``batched_pdas`` over the stacked lanes from their initial points.

Traffic parameters: ``block`` (the engine's tile size).  The traffic runs
one phase, ``pdas``.
"""

from lpbench.program import mod, pdas_config, pdas_host, standard_forms

host = pdas_host  # one phase's result as host arrays
OPERANDS = "sparse"


def setup(drv):
    """(the engine, the stacked states)."""
    if [p["solver"] for p in drv.phases] != ["pdas"]:
        raise ValueError("sparse_fleet runs one pdas phase")
    pdas = mod("solvers.pdas")
    sfs = standard_forms(drv.fleet)
    kw = dict(block=drv.traffic["block"], dtype=drv.dtype, device=drv.device)
    st0, engine = pdas.make_pdas_sparse(sfs[0], **kw)
    states = [st0] + [pdas.make_pdas_sparse(sf, engine=engine, **kw)[0] for sf in sfs[1:]]
    return engine, mod("parallel").stack_sparse_states(states)


def call(drv, state, cap):
    engine, stacked = state
    cfg = pdas_config(drv.phases[0], cap)
    return [mod("parallel").batched_pdas(stacked, cfg, engine=engine)]
