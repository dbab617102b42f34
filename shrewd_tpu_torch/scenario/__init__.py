"""Scenario-matrix campaigns: cross-product coverage with a closed-loop
protection search (port of ``shrewd_tpu/scenario/``).

One declarative ``ScenarioMatrix`` expands to the full (workloads ×
SimPoint windows × fault targets × protection schemes × thermal
envelopes) cross-product as a fleet tenant set (``matrix.py``);
``ScenarioRunner`` admits it through the resident ``CampaignScheduler``
and closes the loop (``runner.py``); ``pareto.py`` folds the live
per-cell tallies into ``search/protect.py``'s design-space algebra
after fleet ticks — pruning Pareto-dominated cells through the
scheduler's journaled ``revoke_quota`` seam and emitting the
``PARETO_<tag>.json`` area-vs-system-SDC front as an atomic campaign
artifact.

Matrices are host-side data; device work starts when the scheduler
elaborates cells or the Pareto fold calls into ``search/protect``.
``FederatedScenarioRunner`` runs the same closed loop over a federation
of pods (``shrewd_tpu_torch/federation/``)."""

from shrewd_tpu_torch.scenario.matrix import (COHERENCE, KNOWN_TARGETS,
                                              MATRIX_SCHEMA, Cell,
                                              ScenarioMatrix, cell_seed)
from shrewd_tpu_torch.scenario.pareto import (PARETO_SCHEMA, artifact,
                                              artifact_path, cell_point,
                                              design_search, dominates,
                                              prune_decisions,
                                              write_artifact)
from shrewd_tpu_torch.scenario.runner import (MATRIX_DOC, PRUNE_REASON,
                                              FederatedScenarioRunner,
                                              ScenarioRunner)

__all__ = [
    "COHERENCE", "KNOWN_TARGETS", "MATRIX_SCHEMA", "Cell",
    "ScenarioMatrix", "cell_seed",
    "PARETO_SCHEMA", "artifact", "artifact_path", "cell_point",
    "design_search", "dominates", "prune_decisions", "write_artifact",
    "MATRIX_DOC", "PRUNE_REASON", "FederatedScenarioRunner",
    "ScenarioRunner",
]
