"""Campaign plans: the declarative description of an SFI sweep (the port's
copy of ``shrewd_tpu/campaign/plan.py``; every class has the reference's
``to_dict`` / ``from_dict``, so a plan's JSON loads in either package).

A ``CampaignPlan`` is the framework's entry-point config — the counterpart of
the reference's driver script arguments (``x86_spec/x86-spec-cpu2017.py:229-319``)
expressed in the typed config system, so a full campaign is reproducible from
its ``config.json`` dump alone (the reproducibility contract of
``m5.instantiate``'s config dumps, ``python/m5/simulate.py:106-124``).

SimPoint sources polymorph over ``SimPointSpec``:

- ``WorkloadSpec``   — synthesize a window (traffic-generator tier);
- ``TraceFileSpec``  — load a captured ``.npz`` window (ElasticTrace analog);
- ``CheckpointSpec`` — ingest a gem5 checkpoint, restore + re-warm
  (SURVEY §5.4).
"""

from __future__ import annotations

from shrewd_tpu_torch.analysis.config import AnalysisConfig
from shrewd_tpu_torch.chaos import ChaosConfig
from shrewd_tpu_torch.integrity import IntegrityConfig
from shrewd_tpu_torch.models.mesi import MesiConfig
from shrewd_tpu_torch.models.noc import NocConfig
from shrewd_tpu_torch.models.o3 import O3Config, STRUCTURES
from shrewd_tpu_torch.models.ruby import CacheConfig
from shrewd_tpu_torch.parallel.elastic import ElasticConfig
from shrewd_tpu_torch.parallel.pipeline import PipelineConfig
from shrewd_tpu_torch.resilience import ResilienceConfig
from shrewd_tpu_torch.trace import synth
from shrewd_tpu_torch.trace.format import Trace
from shrewd_tpu_torch.utils.config import (Child, ConfigObject, Param, VectorParam)


class SimPointSpec(ConfigObject):
    """Abstract source of one SimPoint's replay window."""

    name = Param(str, "simpoint", "label used in stats/output paths")

    def build_trace(self) -> Trace:
        raise NotImplementedError


class WorkloadSpec(SimPointSpec):
    """Synthetic window (tests / benchmarks / artifact-free runs)."""

    workload = Child(synth.WorkloadConfig)

    def build_trace(self) -> Trace:
        return synth.generate(self.workload)


class TraceFileSpec(SimPointSpec):
    """A captured window on disk (.npz, trace/format.py)."""

    path = Param(str, desc="path to the .npz trace")

    def build_trace(self) -> Trace:
        from shrewd_tpu_torch.trace import format as tf
        trace, _meta = tf.load(self.path)
        return trace


class CheckpointSpec(SimPointSpec):
    """Restore a gem5 checkpoint and re-warm (ingest/warm.py).

    With ``binary`` set, the window is the REAL instruction stream: the
    snapshot-seeded emulator runs forward from the checkpoint PC and the
    macro→µop lifter lifts it (restore-then-rewarm,
    ``src/cpu/o3/cpu.cc:706-799``).  Without it, a synthetic stream runs
    over the snapshot state (artifact-free fallback)."""

    cpt_dir = Param(str, desc="checkpoint directory containing m5.cpt")
    thread = Param(int, 0, "thread context index")
    warmup = Param(int, 1024, "µops retired functionally before capture")
    binary = Param(str, "", "workload ELF for the lifted (real-stream) path")
    max_steps = Param(int, 200_000, "emulated macro-op budget (lifted path)")
    workload = Child(synth.WorkloadConfig)

    def build_trace(self) -> Trace:
        from shrewd_tpu_torch.ingest import (load_arch_snapshot,
                                             window_from_snapshot,
                                             window_from_snapshot_lifted)
        snap = load_arch_snapshot(self.cpt_dir, self.thread)
        if self.binary:
            trace, _meta = window_from_snapshot_lifted(
                snap, self.binary, max_steps=self.max_steps)
            return trace
        return window_from_snapshot(snap, self.workload, self.warmup)


# Tier-qualified structures route to the non-O3 fault kernels
# (campaign/orchestrator.py kernel_for): the cache-lifetime tier
# (models/ruby.py, driven by the simpoint's own access stream), the
# two-core MESI protocol tier, and the NoC tier (models/mesi.py /
# models/noc.py, driven by a seeded coherence torture stream — the
# RubyTester posture: the reference's protocol campaigns run synthetic
# coherence traffic, not SPEC).
TIER_STRUCTURES = (
    "cache:data", "cache:tag", "cache:state",
    "mesi:state", "mesi:tag",
    "noc:router",
)

# reserved pseudo-simpoint under which the plan-level coherence tiers
# (mesi:/noc:) report; a real simpoint may not take this name (state and
# stats would silently merge)
COHERENCE_SP_NAME = "coherence"


def _valid_structures(names: list[str]) -> bool:
    return all(n in STRUCTURES or n in TIER_STRUCTURES for n in names)


class CampaignPlan(ConfigObject):
    """The full sweep: simpoints × structures × precision target."""

    structures = VectorParam(str, ["regfile", "fu"],
                             "structures to measure per simpoint",
                             check=_valid_structures)
    batch_size = Param(int, 4096, "trials per sharded batch")
    target_halfwidth = Param(float, 0.01, "CI half-width stopping target "
                             "(north star: AVF ±1%)")
    confidence = Param(float, 0.95, "CI confidence level")
    max_trials = Param(int, 1_000_000, "per-(simpoint,structure) trial cap")
    min_trials = Param(int, 1000, "trials before the stop rule may fire")
    seed = Param(int, 0, "campaign PRNG seed")
    checkpoint_every = Param(int, 0,
                             "batches between campaign checkpoints (0=off)")
    machine = Child(O3Config)
    # backend failure posture: watchdog timeout, retry/backoff, the
    # device→cpu→oracle degradation ladder, and the escalation budget
    # (shrewd_tpu/resilience.py) — part of the plan so a campaign's
    # resilience behavior is reproducible from its config dump
    resilience = Child(ResilienceConfig)
    # result-integrity posture: canary trials, tally invariants, and the
    # continuous differential audit (shrewd_tpu/integrity.py) — like the
    # resilience child, part of the plan so a campaign's self-validation
    # behavior is reproducible from its config dump
    integrity = Child(IntegrityConfig)
    # elastic multi-host posture: heartbeat cadence/timeouts and the
    # lease-board speculation window (parallel/elastic.py); the
    # coordination directory and worker identity are runtime arguments
    # (--elastic-dir/--worker), not plan state
    elastic = Child(ElasticConfig)
    # deterministic chaos schedule (shrewd_tpu/chaos.py): where this
    # campaign's injected-failure plan comes from, so a chaos run is
    # reproducible from its config dump like every other posture
    chaos = Child(ChaosConfig)
    # pipelined-engine posture (parallel/pipeline.py): sync-interval
    # length, in-flight depth, and the opt-in persistent compilation
    # cache — sync_every = 1 (the default) is exactly the serial loop,
    # and pipelined tallies are bit-identical at any sync_every because
    # per-batch tallies are pure functions of their frozen PRNG keys
    pipeline = Child(PipelineConfig)
    # static-certification posture: the reference audits every compiled
    # campaign step at executable-cache admission; the port compiles no
    # executables and raises for anything but 'off' (the default)
    analysis = Child(AnalysisConfig)
    # non-O3 fault tiers (used only when a tier-qualified structure is in
    # ``structures``)
    cache = Child(CacheConfig)
    mesi = Child(MesiConfig)
    noc = Child(NocConfig)
    stratify = Param(bool, False,
                     "post-stratified AVF estimation "
                     "(parallel/stopping.post_stratified) across every "
                     "structure: cycle octiles for O3/Minor/cache/MESI, "
                     "fault-type classes for the NoC; ~1.2-1.3x fewer "
                     "trials to the CI target on the O3 structures, more "
                     "where outcomes are stratum-determined (NoC)")
    coherence_accesses = Param(int, 512,
                               "torture-stream length for mesi:/noc: tiers",
                               check=lambda v: v > 0)
    coherence_mem_words = Param(int, 256,
                                "memory words behind the coherence stream",
                                check=lambda v: v > 0)
    # federated single-campaign sharding (federation/gateway.py): shard i
    # of N serves the round-robin stripe {i, i+N, i+2N, ...} of the
    # parent campaign's frozen batch-id space.  Per-batch tallies are
    # pure functions of their frozen PRNG keys, so the gateway's
    # order-fixed fold of shard tallies is bit-identical to the solo
    # run.  shard_count == 1 (the default) is exactly the unsharded
    # path — the identity mapping.
    shard_index = Param(int, 0, "this shard's stripe offset in the "
                        "parent campaign's batch-id space",
                        check=lambda v: v >= 0)
    shard_count = Param(int, 1, "round-robin stripe stride (1 = solo)",
                        check=lambda v: v >= 1)

    def __init__(self, simpoints: list[SimPointSpec] | None = None, **kw):
        super().__init__(**kw)
        if self.shard_index >= self.shard_count:
            raise ValueError(
                f"shard_index {self.shard_index} out of range for "
                f"shard_count {self.shard_count}")
        self.simpoints: list[SimPointSpec] = list(simpoints or [])
        for sp in self.simpoints:
            if sp.name == COHERENCE_SP_NAME:
                raise ValueError(
                    f"simpoint name {COHERENCE_SP_NAME!r} is reserved for "
                    "the plan-level coherence tiers (mesi:/noc:)")

    # simpoints are a variable-length polymorphic list, which the static
    # Child-slot system doesn't model; extend the dump/load round-trip.
    def to_dict(self) -> dict:
        out = super().to_dict()
        out["simpoints"] = [sp.to_dict() for sp in self.simpoints]
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "CampaignPlan":
        d = dict(d)
        sps = [SimPointSpec.from_dict(s) for s in d.pop("simpoints", [])]
        plan = super().from_dict(d)
        plan.simpoints = sps
        return plan
