"""The ``plan.elastic`` config child (the port's copy of
``shrewd_tpu/parallel/elastic.py ElasticConfig``).

Only the config is ported, so that a plan's JSON round-trips; the elastic
multi-host layer (heartbeats, the lease board) comes with a later slice,
and ``Orchestrator.attach_elastic`` raises ``NotImplementedError``.
"""

from __future__ import annotations

from shrewd_tpu_torch.utils.config import ConfigObject, Param


class ElasticConfig(ConfigObject):
    """Knobs for the elastic layer (a ``CampaignPlan`` child, so a
    campaign's survivability posture is reproducible from its config
    dump).  The coordination directory and worker name are *runtime*
    identity, not plan state — they come from the CLI/launcher."""

    heartbeat_interval = Param(float, 0.5,
                               "seconds between liveness beats",
                               check=lambda v: v > 0)
    heartbeat_timeout = Param(float, 5.0,
                              "seconds without a beat before a worker is "
                              "declared lost and its leases are revoked",
                              check=lambda v: v > 0)
    lookahead = Param(int, 2,
                      "batches a worker may speculatively run ahead of the "
                      "one blocking accumulation (bounds wasted work past "
                      "convergence)", check=lambda v: v >= 0)
    poll_interval = Param(float, 0.05,
                          "seconds between lease-board polls while blocked",
                          check=lambda v: v > 0)
    claim_wait = Param(float, 120.0,
                       "max seconds blocked on a live peer's lease before "
                       "the worker gives up (guards against undetectable "
                       "wedges; lost workers are revoked, not waited out)",
                       check=lambda v: v > 0)
