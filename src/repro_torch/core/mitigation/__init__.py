"""Mitigation lab: congestion mitigations as searchable objects (the
paper's closing charge, "guide researchers and HPC architects in
designing more effective congestion-control mechanisms and network
load-balancing strategies").

* :mod:`search`: bounded CC / routing knob spaces expanded into stacked
  ``SimParams`` and swept through the batched engine as one batch, plus a
  gradient tier that differentiates victim goodput through the steps.
* :mod:`score`: multi-scenario panels drawn from the scenario registry,
  per-candidate metrics (victim slowdown, aggressor goodput, Jain
  fairness), Pareto frontier and per-fabric winner selection.
* :mod:`agents`: random-walk, GA, CMA-ES and BO search agents over the
  batched evaluator.
"""
from repro_torch.core.mitigation import score, search  # noqa: F401
