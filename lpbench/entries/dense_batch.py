"""The dense padded batch: every lane embedded once in set-up as one padded
batch (``api.embed_batch``), and a call that runs the traffic's phases
over all lanes under ``utils.lanes.vmap``: the first phase ``pdas`` from
the solver's own initial point, each later phase started from the one
before it as the port's two-phase flows hand over (``make_pdas_dd(warm=)``
for the double-word finisher, ``make_pdas(warm=)`` for a float32 phase,
which the pilot's control runs in the finisher's place).

Traffic parameters: ``pad_multiple`` (the padded box).
"""

from lpbench.program import mod, pdas_config, pdas_host, standard_forms

host = pdas_host  # one phase's result as host arrays
OPERANDS = "dense"


def setup(drv):
    """The embedded batch (``BatchEmbed``)."""
    return mod("api").embed_batch(standard_forms(drv.fleet),
                                  pad_multiple=drv.traffic["pad_multiple"],
                                  dtype=drv.dtype, device=drv.device)


def _states(phase, cfg, lps, prev):
    lanes = mod("utils.lanes")
    pdas, pdas_dd = mod("solvers.pdas"), mod("solvers.pdas_dd")
    if prev is None:
        return lanes.vmap(lambda lp: pdas.make_pdas(lp, cfg), lps)
    if phase["solver"] == "pdas_dd":
        return lanes.vmap(lambda lp, r: pdas_dd.make_pdas_dd(lp, warm=r), lps, prev)
    return lanes.vmap(lambda lp, r: pdas.make_pdas(lp, cfg, warm=pdas.PDASState(
        x=r.x, y=r.extra["y"], w=r.extra["w"], z=r.extra["z"], lp=None)), lps, prev)


def call(drv, embed, cap):
    """Each phase once over all lanes; the phases' results in order."""
    par = mod("parallel")
    results, prev = [], None
    for phase in drv.phases:
        cfg = pdas_config(phase, cap)
        states = _states(phase, cfg, embed.stacked_lp, prev)
        run = par.batched_pdas_dd if phase["solver"] == "pdas_dd" else par.batched_pdas
        prev = run(states, cfg)
        results.append(prev)
    return results
