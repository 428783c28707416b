"""Input generators of the benchmark (NumPy only, no program imports).

A configuration names its generator (``"generator"``); the harness loads
``gen/<generator>.py`` by that name and calls its ``make(config, seed,
lanes)``, which returns a fleet (see :class:`constructed_optimum.Fleet`).
"""

from lpbench.gen.constructed_optimum import Fleet, base_instance, fleet

__all__ = ["Fleet", "base_instance", "fleet"]
