"""The dense padded batch on a dense-A tile engine: as ``dense_batch``, every
lane embedded once in set-up as one padded batch (``api.embed_batch``),
and in set-up too the tile engine of the padded A's pattern
(``sparse.engine_for`` at the traffic's block), which every phase's batched
loop takes as ``engine=``: each lane assembles the tiles of its N from its
own scaled A (``torch.matmul`` over row blocks), one batched tile-kernel
launch a panel for all the lanes, and refines against the unassembled
operator with the dd kernels.

Traffic parameters: ``pad_multiple`` (the padded box), ``block`` (the
engine's tile size).
"""

from lpbench.entries.dense_batch import _states
from lpbench.program import mod, pdas_config, pdas_host, standard_forms

host = pdas_host  # one phase's result as host arrays
OPERANDS = "dense"


def setup(drv):
    """(the embedded batch, the engine of lane 0's padded A)."""
    embed = mod("api").embed_batch(standard_forms(drv.fleet),
                                   pad_multiple=drv.traffic["pad_multiple"],
                                   dtype=drv.dtype, device=drv.device)
    engine = mod("sparse").engine_for(embed.stacked_lp.A[0], block=drv.traffic["block"],
                                      device=drv.device)
    return embed, engine


def call(drv, state, cap):
    """Each phase once over all lanes on the engine; the phases' results in
    order."""
    embed, engine = state
    par = mod("parallel")
    results, prev = [], None
    for phase in drv.phases:
        cfg = pdas_config(phase, cap)
        states = _states(phase, cfg, embed.stacked_lp, prev)
        run = par.batched_pdas_dd if phase["solver"] == "pdas_dd" else par.batched_pdas
        prev = run(states, cfg, engine=engine)
        results.append(prev)
    return results
