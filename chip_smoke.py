#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero, printing no result, without one), the
CUDA toolkit's nvcc and g++.  It imports ``shrewd_tpu_torch`` and nothing of
JAX.  Phases, each fatal:

1. environment: torch/CUDA/nvcc versions, the card's name and power limit;
2. build the fast-pass kernel (``shrewd_tpu_torch/csrc/taint_fast.cu``)
   and the serial C++ oracle from the checkout;
3. the flagship window — ``generate_trace(seed=1, n=4096, nphys=256,
   mem_words=4096, working_set_words=1024)`` with the default
   ``O3Config()`` — as a ``TrialKernel`` on the card;
4. the kernel against its plain PyTorch version on the same device tensors
   (outcome, escape and overflow flags, final sets and live-step counts
   bitwise equal): (a) 131072 regfile lanes from
   ``trial_keys(campaign_key(0), 131072)``, (b) 16384 lanes of every fault
   kind with ``may_latch`` at a shadow coverage of 0.5, so that some are
   detected, (c) the same lanes through the K=4 build, where some sets
   overflow, (d) the lanes of (a) on the flagship window with one loud
   step (its middle branch's outcome inverted before recording), where
   some lanes stop, and (e) the structure lanes (below);
5. the main path, ``run_keys(trial_keys(campaign_key(0), 131072),
   "regfile")``, with the kernel's launch count zeroed just before it: the
   tally sums to the batch, the first 4096 keys give the JAX reference's
   pinned tally, and 2048 outcomes equal the serial C++ oracle's;
6. timings with CUDA events (median of 3 after a warm-up; the host
   loops, row pass and dense re-run, one timed call each, warmed by
   phase 5; ``record_golden`` one timed call, warmed by phase 3;
   ``run_keys`` the seconds of phase 5's counted run; K1's
   plain version once, warmed by phase 4) beside the card's name and
   power limit; K1's bound two ways (the full body on every
   step from each landing, and the function's own need from the
   kernel's hit counts: the kernels line's) and its longest walk;
7. the chunked window — ``generate_trace(seed=16, n=32768, nphys=256,
   mem_words=4096, working_set_words=1024)`` as a ``TrialKernel`` on the
   card — preprocessed at S = 16384 (C = 2); its last boundary equals the
   C++ golden replay's final state (phases 7-10 and 12 run at a quarter
   of bench.py's depth, cut twice for the script's time limit: two
   chunks and two fast waves, the same keys and gate lanes as at 131072
   µops);
8. the chunk kernel (K2) against its plain version on the same device
   tensors (sets, live-step counts and the five flags bitwise equal):
   (b) 2048 lanes of every fault kind with ``may_latch`` at a shadow
   coverage of 0.5, a third of them carried in with seeded sets and
   negative coordinates, on the NOP-padded last chunk of S = 15000 (C =
   3), so that some are detected; (c) the same through the K = 4 build,
   where some sets overflow; (d) the lanes of (b) on that chunk with one
   loud step, where some lanes stop;
9. the chunked main path, ``ChunkedCampaign(kernel, chunk=16384)
   .outcomes_from_keys(...512 keys..., "regfile")``, with K2's launch
   count zeroed just before it: one K2 launch per fast wave, no call of the
   plain version; then batch (a): each of the main path's K2 waves (the
   512 regfile lanes of ``trial_keys(campaign_key(163), 512)``, each on its
   landing chunk, with the lanes carried into chunk 1 and the null
   padding) against the plain version on its own inputs; gates (i) taint
   = exact engine on 64 keys of ``campaign_key(161)``, (ii) the 512
   outcomes = the serial C++ oracle, (iii) the 64 taint outcomes = the JAX
   reference's, pinned, (iv) taint = exact at S = 6000 (C = 6) with
   ``carry_horizon=2``, some lanes carried;
10. the chunked path's timings (one timed call after a warm-up;
    ``outcomes_from_keys`` and its exact fallback timed in phase 9's
    counted run): trials/s of ``outcomes_from_keys``, K2 on each of the
    main path's waves and its plain version (timed once, in (a)), the
    chunk record, the setup gathers, the exact fallback and the
    preprocessing; K2's bound over those waves (the function's own need,
    and the full body from each landing) and each wave's longest walk
    with its ns per step;
11. the structure path: the flagship window as a ``TrialKernel`` with
    ``O3Config(shadow_model="fupool")`` (SHREWD's shadow-FU pool under
    the scoreboard's schedule; its availability counters printed); for
    each of fu, rob, iq, lsq and latch, ``run_keys(trial_keys(
    campaign_key(0), 131072), s)`` with K1's launch count zeroed just
    before it: exactly one K1 launch and no call of its plain version,
    the tally sums to the batch, the first 1024 keys give the JAX
    reference's pinned tally, 2048 outcomes equal the serial C++
    oracle's under the kernel's coverage, and K1 equals its plain version
    bitwise on all 131072 lanes; the counted call's seconds, and K1 on
    its lanes (median of 3);
12. the campaign loop: ``run_until_ci(ShardedCampaign(kernel, None, s,
    stratify=True), seed=0, simpoint_id=0, structure_id=k,
    batch_size=4096, target_halfwidth=0.01)`` for regfile and fu, K1's
    count zeroed before each: converged, one K1 launch per batch, the
    tallies, strata, trials, batches and interval equal the JAX
    reference's pins; then, untimed, one ``tally_batch`` of 512 fu keys
    through the ``chunked=`` route on the chunked window at chunk 16384
    (K2's count zeroed before it): one K2 launch per fast wave, no call of
    the plain chunk scan, and the tally equals the C++ oracle's (K2 is
    held against its plain version in phases 8 and 9, not on this route);
13. the campaign CLI, in-process (``shrewd_tpu_torch.main.main``): the
    flagship window saved with ``trace.format.save`` and a plan JSON
    (``TraceFileSpec``, regfile and fu, batch 4096, ``O3Config(
    shadow_model="fupool")``, stratified, integrity at its defaults);
    (b) at target 0.005 ``run`` serial (its host syncs counted,
    ``torch.cuda.set_sync_debug_mode``), ``--sync-every 4
    --pipeline-depth 2`` and ``--until-ci`` each give ``PIN_CLI``, the
    until-CI run consuming the serial run's batches; (c) a serial run
    with ``checkpoint_every=1`` drained after its third batch and
    finished by ``resume`` gives ``PIN_CLI`` too, and (a) its regfile
    batches show the stratified rule at target 0.01 first firing on the
    JAX reference's ``PIN_CI``: computed here by ``stop_record``, not
    decided by the CLI (a run of its own at 0.01 repeated the 0.005
    run's first batches, and was cut for time).  Every run: rc 0, every
    batch on the device tier,
    ``resilience.tier_trials`` 0 for cpu and oracle, the integrity
    counters clean, K1's launches exactly the batches plus two per canary
    run plus one per audited batch (told apart by their lane counts), no
    call of K1's plain version on card tensors; K1 held against its plain
    version on the first regfile and fu batch launch;
14. the tier structures (no K1 or K2 on this path; their hot loops are
    the MESI walk and the flit pipeline, torch step loops): (a) the
    flagship window's access stream, the L1 (``CacheConfig()``) and
    chained L2 (``CacheConfig(n_sets=256, n_ways=8)``) timelines and
    kernels on the card, and at the plan's defaults the torture stream
    (512 accesses over 256 words, seed 0), the MESI golden walk, the
    message trace and ``NocKernel`` with its horizon, each timed; (b) per
    structure on ``trial_keys(campaign_key(0), ·)`` — cache data, tag and
    state at 131072 keys on both levels, MESI state, tag, dir and tbe and
    the NoC router at 4096 — the per-key outcomes: the first keys give
    the JAX reference's pinned tally, the first 512 equal the CPU
    kernel's, 64 MESI lanes equal ``scalar_mesi`` (lanes of reference
    fault R6's class counted apart), and 64 constructed lanes of the four
    pipeline types equal ``scalar_flit_sim`` with the outcome rule; then
    ``run_keys`` timed (median of 3 for the cache), its tally the
    outcomes' count, and the µs per step of both loops; a batch step's
    parts (draws, outcomes, strata and tally) and the 2-key seed canary
    timed with CUDA events for cache L1 data and state, MESI state and
    the NoC router; (c) 16 cores on
    a 4x4 mesh, one batch of 4096 keys per coherence structure, 32
    outcomes equal to the scalar oracles; (d) the campaign CLI
    in-process over the six tier structures (``PIN_TIER_CLI``; serial,
    ``--until-ci``, and a run drained after its first coherence batch
    and finished by ``resume``): rc 0, every result the JAX reference's,
    every batch on the device tier, integrity clean, the seed canaries
    run and passed, no K1 launch and no call of its plain version;
15. multi-device campaigns on the one card, phase 13's plan: (a) the
    collective mesh at world size 1 — the script initialises a one-rank
    NCCL group on a free local port, and the CLI, in-process with the
    default mesh, runs the plan at target 0.01 under a chaos plan that the
    device tier alone survives (a wedge under ``--dispatch-timeout``, a
    transient device ``backend_error``, a ``corrupt_tally`` and a
    ``torn_checkpoint`` with ``checkpoint_every=1``): rc 0, ``make_mesh()``
    spans the group, the tallies' ``all_reduce`` ran over NCCL, every
    fault injected was survived, the integrity counters show the
    quarantine and its recovery, every batch on the device tier, the
    results ``PIN_CI``, K1's launches exactly the batches plus the
    re-dispatches, two per canary run and one per audited batch, no call of
    its plain version on card tensors, K1 held against its plain version
    on the first batch launch; then the group is destroyed; (b) two
    elastic workers on the card, ``python -m
    shrewd_tpu_torch.parallel.launch --mode elastic --num-processes 2
    --kill-worker 1 --at-batch 2`` over the plan at target 0.005: worker 1
    dies with rc 137 at its second dispatched batch after publishing a
    result, the survivor revokes its lease, reclaims the batch and
    finishes with ``PIN_CLI``, the two workers computed each batch once
    between them, and in each worker K1's launches are exactly the
    batches it computed plus its re-dispatches, two per canary run and one
    per audited batch, with no call of K1's plain version on card tensors.
    One card serves both workers: the times are not a scaling number.
16. real workload binaries, built from ``workloads/`` with this machine's
    gcc (ptrace, objdump and nm are checked first; a failure is fatal):
    (a) ``IngestPipeline`` on ``intmm.c`` in a fresh ``ArtifactStore`` at
    ``DEFAULT_AXES`` with ``preprocess=True, chunk=1024``: every stage
    journaled, 3 windows of 2 chunks or more, a second run warm-starts
    with 0 captures and 0 lifts, and ``lzss.c`` at ``DEFAULT_AXES`` is
    quarantined at ``capture`` with a durable ``ingest_quarantine``
    record; each stage's seconds printed; (b) ``resolved_plan`` → the
    campaign CLI in-process (regfile and fu, batch 4096, stratified,
    target 0.01): rc 0, every batch on the device tier, K1's launches
    exactly the batches plus two per canary run and one per audited batch,
    no call of its plain version on card tensors, K1 held against its
    plain version on each window's first batch, 2048 outcomes per window
    equal to the C++ oracle's; (c) ``ChunkedCampaign(kernel, chunk=1024,
    store=…)`` on each window: opened from the store with no
    preprocessing, one K2 launch per fast wave, each held against its
    plain version, 512 outcomes equal to the exact engine's; (d)
    ``python -m shrewd_tpu_torch hostdiff`` on ``sort.c`` (``--mode
    output --trials 16`` and ``--mode device64 --trials 8``, each with
    ``--out``): rc 0 and the one-line JSON, and in the report no
    ``diverged_resolution_failed`` and every escalated trial classified
    by the emulator; host, device and escalation seconds apart, from the
    library's ``run_host`` and ``run_device`` on 8 trials;
    ``run_device`` over 4096 coordinates on the card equal to the CPU's
    lane for lane, with the peak allocated memory; the memmap dense
    replay's µs per step beside the same window's without the memmap
    (one timed call each, no warm-up run).
    No gate holds a lifted window against a tally pinned elsewhere.
17. a gem5 checkpoint through the port (``sort.c`` built as in phase 16):
    (a) its marker window captured alone, ``snapshot_from_capture`` →
    ``write_arch_snapshot`` (``m5.cpt``, the ``config.json`` sidecar and
    gzipped stores) → ``load_arch_snapshot``: pc, the 16 GPRs and the
    memory image equal the capture's; ``window_from_snapshot_lifted``
    over every captured step: the emulator runs them all and the lift
    rate is at least 0.95; the card's golden record of the restored
    window neither diverges nor traps, its 16 GPRs equal the capture's
    last step masked to 32 bits, and ``memchecker.check_trace`` finds
    every load clean; (b) the campaign CLI in-process on a plan with one
    ``CheckpointSpec(binary=…)`` simpoint (regfile and fu, batch 2048,
    stratified, target 0.02), K1's count zeroed just before it, then on a
    ``TraceFileSpec`` of the same window under the same name and seed:
    rc 0, equal per-structure trials and outcomes in ``stats.json``,
    every batch on the device tier, K1's launches exactly the batches
    plus two per canary run and one per audited batch, no call of its
    plain version on card tensors, K1 held against its plain version on
    the first batch, ``stats.txt`` read back by ``load_stats_txt`` and
    the plan's structures by ``load_config_json`` / ``find_params``; (c)
    the CLI's ``trace -n 64 --all`` on the card, byte-equal to
    ``--platform cpu``, then ``trace --pipeline -n 32`` and ``trace
    --workload workloads/sort.c -n 16``: rc 0 and the lines asked for.
18. the protection search, the thermal network and the scenario matrix:
    (a) ``DesignSpace`` of 6 seeded structure profiles x 4 schemes (4096
    configs) on the card against the same space on the CPU: rates within
    ``rtol=1e-6``, equal assignment and front; a 4-node
    ``ThermalNetwork`` over 10,000 steps, card against CPU within
    ``rtol=1e-5``; ``shadow_scheme(kernel, keys=trial_keys(campaign_key(
    0), 4096))`` on the flagship window under ``shadow_model="fupool"``:
    K1's count zeroed first, exactly one launch, bitwise equal to its
    plain version; (b) the matrix ``port10`` through ``python -m
    shrewd_tpu_torch.tools.scenario --plan m.json --serve
    --pareto-every 1``, in process: the flagship window at full width,
    targets regfile, ``mesi:state`` and ``noc:router`` at the plan's
    coherence defaults, schemes parity (a strict-priority class above)
    and secded, envelopes tnom and hot (100 °C), batch 2048, stratified,
    target 0.02, at most 8192 trials, integrity at its defaults — 12
    cells: rc 0, every cell complete or pruned, in each prune group whose
    parity cell converged the secded cell pruned by it through a
    journaled ``revoke`` (at least one), the regfile and MESI thermal
    mates' raw tallies equal, one completed O3 and one completed
    coherence cell equal to a solo serial ``Orchestrator`` run on the
    card, one kernel built for the O3 cells' one window and config, every
    batch on the device tier and the integrity counters clean, K1's
    launches exactly the O3 cells' batches plus two per canary run plus
    one per audited batch, no call of its plain version on card tensors
    and K1 bitwise equal to it on the first batch, ``metrics.json`` and
    the Prometheus text read back; the wall seconds, each cell's batches
    and each family's seconds a batch printed; (c) ``--status`` and
    ``--pareto`` on that directory: rc 0, the re-emitted artifact equal
    to (b)'s.

Batch (e) of phase 4 holds K1 against its plain version on the lanes the
structure path draws: 2048 each of fu, rob, iq, lsq and latch from the
port's own samplers, with wrong-path sentinels, pipeline bubbles and the
FU pool's coverage.

Phases 1-10 run alone in this process, so the kernels line's times
(phases 6, 9 and 10) are taken with nothing else on the card.  Phases 13
and 14 + 18 then run in two child processes of this script, one lane
each (``python3 chip_smoke.py --lane NAME RESULT``: its own launch
counters, each zeroed before its path as here; the lane's output is
printed when it ends and its results come back as JSON), beside this
process's phases 11, 12 and 15.  Phases 16 and 17, which trace binaries
with ptrace, run alone after the lanes end.  The seconds of phases 11-15
and 18 are readings taken beside one another.

Each phase prints its seconds.  The line before the last is the kernels'
JSON record (K1 ``taint_fast`` and K2 ``taint_chunk``); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

N_KEYS = 131072
N_PIN = 4096
# the JAX reference's regfile tally (masked, sdc, due, detected) for the
# first 4096 keys of trial_keys(campaign_key(0), .) on the flagship window
# (shrewd_tpu TrialKernel.run_keys on CPU; tests/test_torch_trial.py
# recomputes it and holds it equal to this constant)
PIN_TALLY = [3095, 450, 551, 0]
N_ORACLE = 2048
N_MIXED = 16384
REPS = 3                        # phases 6 and 11: K1 median of 3
REPS_HOST = 1                   # phase 6's host-driven loops (row pass,
                                # dense re-run): seconds each, one timed
                                # call (timing depth, no gate)
REPS_CHUNKED = 1                # phase 10's K2 waves, chunk record, setup
MIXED_COVERAGE = 0.5            # shadow coverage of batches (b) and (c)
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
# K1's work is 32-bit integer compare/select/logic: 132 SMs x 64 INT32
# lanes per SM (H100 whitepaper) x 1.98 GHz boost clock
H100_INT32_OPS_PER_S = 132 * 64 * 1.98e9

# K1's operations, counted from the step body of taint_fast.cu: one per
# comparison, arithmetic, logic or select operator (a ternary is one
# select) on the path a live regfile lane takes (MAY_LATCH false, so its
# opcode is the golden one).  Every live step runs OPS_STEP scalar
# operations — loop and stream decode 8, at_uop 1, landing test 3,
# operand read 18, execute 21 (the ALU switch as 3), memory address and
# traps 35, load test 1, branch and liveness 8, store tests 11,
# writeback tests 13, flags 7 — and two K-wide operand lookups.  A K-wide
# set pass costs per slot: lookup 4 (compare, or, select, add), remove 2
# (compare, select), upsert 7 (two compares and two selects to find the
# slot, a compare and two selects to write it) plus 3 to pick the slot.
OPS_STEP = 126
OPS_LOAD = 11           # + a lookup: golden_here, the value, the escape
OPS_STORE = 3           # + a remove: the store's own tests
OPS_WRITE = 4           # + a remove: the writeback's own tests
OPS_LANDING = 3         # + a lookup and an upsert: the REGFILE flip
# The function's own need (need_operations): a full step also rebuilds
# the set's membership filter, OPS_FILTER per slot (compare, hash
# multiply, shift, or).  A step that touches no tag of the lane's set
# changes nothing and needs no operation: the bound charges it none.  The
# kernel still walks it, at OPS_UNTOUCHED each — the warp's step (select,
# min-reduction, end test) 3, the tile test 3, lane and liveness tests 2,
# the record's address and two shared loads 4, landing and loud tests 5,
# the probe's two words 3, the filter test 4, the hit and miss counts 2,
# the full test 1, the next step 3 — a cost of this design, reported
# beside the bound ("untouched_ops"), which a per-tag next-touch index
# would remove.
OPS_FILTER = 4
OPS_UNTOUCHED = 30

# the chunked path (phases 7-10): bench.py:505-510's window and chunk
# at a quarter of their depth (n 131072, chunk 65536 there)
CHUNK_WINDOW = dict(seed=16, n=32768, nphys=256, mem_words=4096,
                    working_set_words=1024)
CHUNK = 16384
CHUNK_SMALL = 15000             # a second chunking: C = 3, NOP-padded tail
# gate (iv)'s chunking: at 32768 µops S = 6000 (C = 6, NOP-padded tail)
# carries 2 gate lanes past a boundary, S = 9000 only 1 (CPU rehearsal)
CHUNK_HORIZON = 6000
N_CHUNK_KEYS = 512
CHUNK_SEED = 163
GATE_SEED = 161
N_GATE = 64
N_CHUNK_MIXED = 2048
# the JAX reference's taint-engine outcomes (0 masked, 1 sdc, 2 due,
# 3 detected) for trial_keys(campaign_key(161), 64) on that window at
# chunk 16384 (shrewd_tpu ChunkedCampaign on CPU;
# tests/test_torch_chunked.py recomputes it and holds it equal)
PIN_CHUNKED = ("00000000002000000000200000000000"
               "00000020020000000022000020000002")

# the structure path (batch (e), phases 11-12): the flagship window with
# SHREWD's structural shadow-FU model
FLAGSHIP = dict(seed=1, n=4096, nphys=256, mem_words=4096,
                working_set_words=1024)
N_STRUCT_MIXED = 2048           # batch (e): lanes per structure
N_PIN_S = 1024
# the JAX reference's tallies (masked, sdc, due, detected) of the first
# 1024 keys of trial_keys(campaign_key(0), .) per structure on the
# flagship window under O3Config(shadow_model="fupool") (shrewd_tpu
# TrialKernel.run_keys on CPU; tests/test_torch_structure_pins.py
# recomputes them and holds them equal to this constant)
PIN_STRUCTURES = {"fu": [260, 39, 464, 261], "rob": [818, 31, 175, 0],
                  "iq": [866, 37, 121, 0], "lsq": [437, 120, 467, 0],
                  "latch": [569, 85, 370, 0]}
# the JAX reference's run_until_ci(ShardedCampaign(kernel, one-device
# mesh, s, stratify=True), seed=0, simpoint_id=0, structure_id=k,
# batch_size=4096, target_halfwidth=0.01) on that kernel, k = s's position
# in STRUCTURES (tests/test_torch_campaign_pins.py recomputes them)
CI_BATCH = 4096
CI_TARGET = 0.01
PIN_CI = {
    "regfile": dict(
        tallies=[6182, 925, 1085, 0], trials=8192, batches=2,
        strata=[[872, 27, 144, 0], [869, 18, 134, 0], [871, 33, 131, 0],
                [794, 57, 180, 0], [797, 36, 136, 0], [839, 60, 123, 0],
                [746, 143, 154, 0], [394, 551, 83, 0]],
        avf_interval=(0.245361328125, 0.23658525821866982,
                      0.2541373980313302)),
    "fu": dict(
        tallies=[790, 658, 1624, 1024], trials=4096, batches=1,
        strata=[[649, 1, 2, 816], [0, 0, 0, 208], [90, 623, 1491, 0],
                [1, 34, 131, 0], [50, 0, 0, 0], [0, 0, 0, 0],
                [0, 0, 0, 0], [0, 0, 0, 0]],
        avf_interval=(0.55712890625, 0.5523538694969201,
                      0.5619039430030799)),
}
N_CHUNK_FU = 512                # phase 12: the chunked route, fu keys
INGEST_CHUNK = 1024             # phase 16: the preprocess stage's chunk
N_HOSTDIFF = 4096               # phase 16 (d): run_device card vs CPU
N_SPLIT = 8                     # phase 16 (d): host / device / escalation
# phase 16 (d): the hostdiff CLI's trials in each mode (each escalated
# trial runs the Python emulator: 32 output trials took 38.6-166.1 s on
# H100 hosts)
HOSTDIFF_TRIALS = {"output": 16, "device64": 8}
CPT_BATCH = 2048                # phase 17 (b): the checkpoint campaign's
CPT_TARGET = 0.02               # batch and target: a batch or two each
# phase 18: the protection search (6 structures x 4 schemes = 4096
# configs), the thermal network's steps, shadow_scheme's fu batch, and the
# scenario matrix's tag, batch, target and trial cap
SEARCH_STRUCTURES = 6
THERMAL_STEPS = 10000
SHADOW_KEYS = 4096
MATRIX_TAG = "port10"
MATRIX_BATCH = 2048
MATRIX_TARGET = 0.02
MATRIX_MAX_TRIALS = 8192
# phase 13, the campaign CLI: the JAX reference's results at target 0.005
# for the same campaign (batch 4096, stratified, fupool; the orchestrator
# derives its keys as run_until_ci does, so these are run_until_ci's;
# tests/test_torch_orchestrator_pins.py recomputes regfile's, and fu
# converges in its first batch, as at 0.01)
CLI_TARGET = 0.005
PIN_CLI = {
    "regfile": dict(
        tallies=[21652, 3221, 3799, 0], trials=28672, batches=7,
        strata=[[2982, 84, 549, 0], [3037, 65, 467, 0], [3002, 103, 533, 0],
                [2805, 204, 609, 0], [2891, 154, 469, 0],
                [2895, 218, 448, 0], [2670, 538, 451, 0],
                [1370, 1855, 273, 0]]),
    "fu": {k: PIN_CI["fu"][k] for k in ("tallies", "trials", "batches",
                                        "strata")},
}

# phase 14, the tier structures.  The coherence tiers' stream at the
# plan's defaults: torture_stream(MesiConfig(), 512, 256, seed=0) with the
# orchestrator's seeded memory image; the NoC under NocConfig()
COHERENCE_ACCESSES = 512
COHERENCE_MEM_WORDS = 256
N_TIER_CACHE = 131072            # keys per cache structure
N_TIER = 4096                    # keys per MESI / NoC structure
N_PIN_CACHE, N_PIN_MESI, N_PIN_NOC = 4096, 512, 64
N_TIER_CPU = 512                 # keys held card == CPU
N_TIER_ORACLE = 64               # MESI lanes held against scalar_mesi, and
                                 # pipeline lanes against scalar_flit_sim
N_SCALE_ORACLE = 32              # (c): outcomes held against the oracles
# the JAX reference's tallies (masked, sdc, due, detected) of the first
# keys of trial_keys(campaign_key(0), .): the flagship window's L1
# (CacheConfig()) and chained L2 (CacheConfig(n_sets=256, n_ways=8)) of
# CacheHierarchy.build, 4096 keys each; the MESI structures, 512 keys; the
# NoC router, 64 keys (tests/test_torch_tier_pins.py recomputes them)
PIN_CACHE = {"l1": {"data": [2557, 1539, 0, 0], "tag": [2570, 1526, 0, 0],
                    "state": [2570, 1526, 0, 0]},
             "l2": {"data": [4096, 0, 0, 0], "tag": [4096, 0, 0, 0],
                    "state": [4096, 0, 0, 0]}}
PIN_MESI = {"state": [353, 159, 0, 0], "tag": [360, 152, 0, 0],
            "dir": [509, 3, 0, 0], "tbe": [506, 6, 0, 0]}
PIN_NOC = [53, 10, 1, 0]
# (d), the campaign CLI over the six tier structures (batch 4096, target
# 0.01, stratified) with the coherence stream cut to 64 accesses, so that
# the reference's results fit a CPU test: the JAX reference's
# run_until_ci on each tier kernel with the orchestrator's key coordinates
# (simpoint 0 for the cache, the coherence pseudo-simpoint 1,000,000 for
# MESI and NoC; structure ids 6-11), which tests/test_torch_tier_pins.py
# recomputes
TIER_CLI_ACCESSES = 64
PIN_TIER_CLI = {
    ("flagship", "cache:data"): dict(
        tallies=[7693, 4595, 0, 0], trials=12288, batches=3,
        strata=[[1304, 235, 0, 0], [1084, 477, 0, 0], [994, 556, 0, 0],
                [974, 576, 0, 0], [882, 581, 0, 0], [864, 680, 0, 0],
                [829, 717, 0, 0], [762, 773, 0, 0]]),
    ("flagship", "cache:tag"): dict(
        tallies=[7696, 4592, 0, 0], trials=12288, batches=3,
        strata=[[1314, 156, 0, 0], [1144, 362, 0, 0], [1034, 528, 0, 0],
                [940, 612, 0, 0], [845, 702, 0, 0], [824, 747, 0, 0],
                [801, 769, 0, 0], [794, 716, 0, 0]]),
    ("flagship", "cache:state"): dict(
        tallies=[7689, 4599, 0, 0], trials=12288, batches=3,
        strata=[[1348, 176, 0, 0], [1139, 389, 0, 0], [1024, 530, 0, 0],
                [895, 583, 0, 0], [888, 724, 0, 0], [797, 736, 0, 0],
                [829, 725, 0, 0], [769, 736, 0, 0]]),
    ("coherence", "mesi:state"): dict(
        tallies=[6764, 5524, 0, 0], trials=12288, batches=3,
        strata=[[522, 1047, 0, 0], [709, 906, 0, 0], [687, 780, 0, 0],
                [686, 800, 0, 0], [1067, 473, 0, 0], [1245, 253, 0, 0],
                [1040, 528, 0, 0], [808, 737, 0, 0]]),
    ("coherence", "mesi:tag"): dict(
        tallies=[6009, 2183, 0, 0], trials=8192, batches=2,
        strata=[[987, 58, 0, 0], [881, 197, 0, 0], [772, 234, 0, 0],
                [673, 295, 0, 0], [757, 261, 0, 0], [756, 259, 0, 0],
                [626, 394, 0, 0], [557, 485, 0, 0]]),
    ("coherence", "noc:router"): dict(
        tallies=[7014, 688, 490, 0], trials=8192, batches=2,
        strata=[[6888, 688, 483, 0], [79, 0, 7, 0], [4, 0, 0, 0],
                [32, 0, 0, 0], [11, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0],
                [0, 0, 0, 0]]),
}


# the phases that run in child processes of this script, one lane each,
# beside this process's phases 11, 12 and 15; none of them traces a binary
LANES = {"cli": ("cli_phase",), "tiers": ("tier_phase", "matrix_phase")}
LANE_PHASES = {"cli": "13", "tiers": "14 and 18"}
LANE_TIMEOUT_S = 900            # from the lanes' start to their last result
_lanes: list = []               # (name, Popen) of the lanes started


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def time_ms(torch, fn, reps: int = REPS, warm: bool = True) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after one
    warm-up run (``warm=False``: the caller has just run ``fn``)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(torch, got, ref, what: str) -> int:
    """Hold the kernel's TaintResult against the plain version's, bitwise;
    returns the largest absolute difference (0)."""
    err = 0
    for field in ("outcome", "escaped", "overflow", "tags", "vals",
                  "steps"):
        a, b = getattr(got, field), getattr(ref, field)
        if a.shape != b.shape:
            fail(f"{what}: {field} shape {tuple(a.shape)} vs "
                 f"{tuple(b.shape)}")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
        if not torch.equal(a.to(torch.int64), b.to(torch.int64)):
            fail(f"{what}: kernel and plain version differ in {field} on "
                 f"{int((d != 0).sum())} entries")
    return err


def mixed_faults(torch, trace, n_lanes: int, seed: int, device):
    """Lanes of every fault kind (1-9), drawn with numpy from a seed."""
    from shrewd_tpu_torch.compat import fault_from_arrays
    rng = np.random.default_rng(seed)
    kind = rng.integers(1, 10, n_lanes)
    cycle = rng.integers(0, trace.n, n_lanes)
    entry = np.where(kind == 1, rng.integers(0, trace.nphys, n_lanes),
                     rng.integers(0, trace.n, n_lanes))
    bit = rng.integers(0, 32, n_lanes)
    shadow_u = rng.random(n_lanes, dtype=np.float32)
    return fault_from_arrays(kind, cycle, entry, bit, shadow_u, device)


def loud_branch(taken: np.ndarray, opcode: np.ndarray) -> tuple:
    """``taken`` with its middle branch's outcome inverted → (taken,
    that branch's step): recorded so, the window has one loud step, where
    every lane that reaches it with an empty set diverges."""
    from shrewd_tpu_torch.isa import uops as U
    br = np.nonzero(U.is_branch(opcode))[0]
    j = int(br[len(br) // 2])
    out = taken.copy()
    out[j] ^= 1
    return out, j


def k1_operations(opcode: np.ndarray, cycle: np.ndarray,
                  steps: np.ndarray, k: int,
                  first: np.ndarray | None = None) -> int:
    """K1's operations on a batch of regfile lanes, from the per-step
    counts above and this run's data: lane l ran ``steps[l]`` live steps
    and its fault landed at step ``cycle[l]`` if that step was live.  A
    store or register write runs a remove or an upsert, depending on the
    lane's deviation; the count takes the cheaper remove, and leaves out
    the store and write of the step on which a lane died, so it is a
    floor.  ``first[l]`` (default 0) is the step from which lane l's work
    is counted; a lane with ``first[l] >= steps[l]`` counts nothing."""
    from shrewd_tpu_torch.isa import uops as U
    lookup, remove, upsert = 4 * k, 2 * k, 7 * k + 3
    ld = U.is_load(opcode).astype(np.int64)
    live = OPS_STEP + 2 * lookup + ld * (OPS_LOAD + lookup)
    full = (live + U.is_store(opcode) * (OPS_STORE + remove)
            + U.writes_dest(opcode) * (OPS_WRITE + remove))
    last = steps.astype(np.int64) - 1
    if (last < 0).any():
        raise ValueError("a lane ran no step")
    first = (np.zeros_like(last) if first is None
             else first.astype(np.int64))
    counted = first <= last
    last, first = last[counted], first[counted]
    cycle = cycle.astype(np.int64)[counted]
    before = np.concatenate([[0], np.cumsum(full)])   # work of steps < i
    ops = int((before[last] - before[first] + live[last]).sum())
    landed = int(((cycle >= first) & (cycle <= last)).sum())
    return ops + landed * (OPS_LANDING + lookup + upsert)


def chunk_faults(trace, lanes: int, n_real: int, S: int, seed: int):
    """Chunk-local faults of every kind (1-9), drawn with numpy from a
    seed: a third carried in (coordinates in [-S, 0)), the rest landing in
    the chunk's first ``n_real`` µops → (fields, carried mask)."""
    rng = np.random.default_rng(seed)
    kind = rng.integers(1, 10, lanes)
    carried = rng.random(lanes) < 1 / 3
    at = np.where(carried, rng.integers(-S, 0, lanes),
                  rng.integers(0, n_real, lanes))
    cycle = np.where(kind == 1, at, rng.integers(-S, S, lanes))
    entry = np.where(kind == 1, rng.integers(0, trace.nphys, lanes), at)
    return (kind, cycle, entry, rng.integers(0, 32, lanes),
            rng.random(lanes, dtype=np.float32)), carried


def seeded_sets(carried: np.ndarray, k: int, nphys: int, mem_words: int,
                seed: int):
    """Deviation sets for the carried lanes, drawn with numpy: 1..k live
    slots at random positions (EMPTY holes between them), distinct
    register and memory tags, random values; EMPTY sets elsewhere."""
    rng = np.random.default_rng(seed)
    tags = np.full((carried.size, k), -1, np.int64)
    vals = np.zeros((carried.size, k), np.int64)
    for lane in np.nonzero(carried)[0]:
        m = int(rng.integers(1, k + 1))
        slots = rng.choice(k, m, replace=False)
        tags[lane, slots] = rng.choice(nphys + mem_words, m, replace=False)
        vals[lane, slots] = rng.integers(0, 1 << 32, m)
    return tags, vals


def wave_lanes(faults, tags0, S: int):
    """The lanes of one of the chunked main path's K2 waves → (landing in
    this chunk, carried in with a non-empty set, null padding) masks."""
    from shrewd_tpu_torch.ops.taint import EMPTY
    kind = faults.kind.cpu().numpy()
    cyc = faults.cycle.cpu().numpy().astype(np.int64)
    if not np.isin(kind, (0, 1)).all():
        raise ValueError("a main-path wave holds regfile and null lanes")
    landing = (kind == 1) & (cyc >= 0) & (cyc < S)
    carried = (tags0 != EMPTY).any(1).cpu().numpy()
    return landing, carried, kind == 0


def k2_operations(opcode: np.ndarray, faults, tags0, steps: np.ndarray,
                  k: int) -> tuple[int, int]:
    """K2's operations on one of the chunked main path's waves, counted as
    K1's (the same step body) over the steps the chunk function needs: a
    lane's work starts at its landing step, or at step 0 if it carries a
    non-empty set in; a lane that does neither runs the golden run and
    needs none → (operations, lane-steps counted)."""
    S = opcode.shape[0]
    landing, carried, _ = wave_lanes(faults, tags0, S)
    cyc = faults.cycle.cpu().numpy().astype(np.int64)
    first = np.where(landing, cyc, np.where(carried, 0, S))
    ops = k1_operations(opcode, np.where(landing, cyc, S), steps, k, first)
    return ops, int(np.maximum(steps.astype(np.int64) - first, 0).sum())


def need_operations(opcode: np.ndarray, loud: np.ndarray, land: np.ndarray,
                    steps: np.ndarray, counts: np.ndarray,
                    k: int) -> tuple[int, int, int]:
    """The operations the function needs on a batch, from this run's
    data: per lane, the full step body (as ``k1_operations`` counts a live
    step, plus the filter rebuild) on its landing step ``land`` (with the
    REGFILE flip; -1: none) and on every loud step it reaches; the
    cheapest full body on each quiet step whose tags truly hit its set
    (``counts[0]``, the kernel's counter).  A quiet step over an empty
    set, or one whose tags miss the set (``counts[1]``), changes nothing
    and needs nothing.  Lane l reaches steps ``< steps[l]`` →
    (operations, full steps, untouched steps the kernel walked)."""
    from shrewd_tpu_torch.isa import uops as U
    lookup, upsert = 4 * k, 7 * k + 3
    body = OPS_STEP + 2 * lookup + OPS_FILTER * k
    full = body + U.is_load(opcode).astype(np.int64) * (OPS_LOAD + lookup)
    last = steps.astype(np.int64) - 1
    land = land.astype(np.int64)
    loud_at = np.nonzero(loud)[0]
    reached = np.searchsorted(loud_at, last, side="right")
    before = np.concatenate([[0], np.cumsum(full[loud_at])])
    landed = (land >= 0) & (land <= last)
    lands = land[landed]
    hits, misses = (c.astype(np.int64) for c in counts)
    ops = (int(before[reached].sum())
           + int(full[lands][~loud[lands]].sum())
           + int(landed.sum()) * (OPS_LANDING + lookup + upsert)
           + int(hits.sum()) * body)
    n_full = (int(reached.sum()) + int((~loud[lands]).sum())
              + int(hits.sum()))
    return ops, n_full, int(misses.sum())


def compare_chunk(torch, got, ref, what: str) -> int:
    """Hold K2's result tuple against the plain version's, bitwise;
    returns the largest absolute difference (0)."""
    err = 0
    names = ("tags", "vals", "steps", "detected", "trapped", "diverged",
             "escaped", "overflowed")
    for name, a, b in zip(names, got, ref):
        if a.shape != b.shape:
            fail(f"{what}: {name} shape {tuple(a.shape)} vs "
                 f"{tuple(b.shape)}")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
        if not torch.equal(a.to(torch.int64), b.to(torch.int64)):
            fail(f"{what}: K2 and plain version differ in {name} on "
                 f"{int((d != 0).sum())} entries")
    return err


def chunked_phases(torch, dev, marks) -> tuple[dict, dict]:
    """Phases 7-10 → (timings, the kernels-line record of K2)."""
    from shrewd_tpu_torch import native
    from shrewd_tpu_torch.isa import uops as U
    from shrewd_tpu_torch.models.o3 import O3Config, compute_shadow_cov
    from shrewd_tpu_torch.ops import chunked as CH
    from shrewd_tpu_torch.ops import classify as C
    from shrewd_tpu_torch.ops import taint_cuda
    from shrewd_tpu_torch.ops import window as W
    from shrewd_tpu_torch.ops.chunked import (ChunkedCampaign,
                                              preprocess_window)
    from shrewd_tpu_torch.ops.taint import (record_chunk, setup_gather,
                                            taint_chunk)
    from shrewd_tpu_torch.ops.taint_cuda import taint_chunk_cuda
    from shrewd_tpu_torch.ops.trial import TrialKernel
    from shrewd_tpu_torch.utils import prng

    # 7. the chunked window
    trace = native.generate_trace(**CHUNK_WINDOW)
    kernel = TrialKernel(trace, O3Config(), device=dev)
    t0 = time.monotonic()
    win = preprocess_window(kernel, CHUNK)
    t_pre = time.monotonic() - t0
    final_reg, final_mem = native.golden_replay(trace)
    if not (np.array_equal(win.gb_reg[win.C], final_reg)
            and np.array_equal(win.gb_mem[win.C], final_mem)):
        fail("the window's last boundary differs from the golden replay")
    log(f"window n={trace.n} S={win.S} C={win.C}: preprocessed in "
        f"{t_pre:.3f} s, last boundary == C++ golden final state")
    marks("7 window")

    # 8. K2 against its plain version on the card; batch (a) is the main
    # path's own waves, held in phase 9 right after the counted run
    camp = ChunkedCampaign(kernel, chunk=CHUNK)
    k = kernel.cfg.taint_k
    keys = prng.trial_keys(prng.campaign_key(CHUNK_SEED, dev), N_CHUNK_KEYS)
    faults = kernel.sample_batch(keys, "regfile")
    max_err = 0
    small = ChunkedCampaign(kernel, chunk=CHUNK_SMALL)
    last = small.C - 1
    n_real = trace.n - last * CHUNK_SMALL
    tr_s, _, gold_s = small.chunk_record(last)
    # coverage 0.5 on the chunk's real µops, 0 on its NOP padding (as the
    # driver pads it)
    cov_s = torch.as_tensor(compute_shadow_cov(
        U.opclass_of(trace.opcode[last * CHUNK_SMALL:]),
        O3Config(shadow_coverage=[MIXED_COVERAGE] * U.N_OPCLASSES))[0],
        device=dev)
    cov_s = torch.cat([cov_s, torch.zeros(CHUNK_SMALL - n_real,
                                          device=dev)])
    fields, carried = chunk_faults(trace, N_CHUNK_MIXED, n_real,
                                   CHUNK_SMALL, 17)
    from shrewd_tpu_torch.compat import fault_from_arrays
    mixed = fault_from_arrays(*fields, dev)
    reg0_s = torch.as_tensor(small.gb_reg[last].astype(np.int64),
                             device=dev)
    setup_s = setup_gather(gold_s, tr_s, reg0_s, mixed)
    for label, kk in (("(b) mixed kinds, carried sets", k),
                      ("(c) mixed kinds, carried sets, K=4", 4)):
        tags0, vals0 = seeded_sets(carried, kk, trace.nphys,
                                   trace.mem_words, 23)
        args = (gold_s, tr_s, cov_s, mixed, *setup_s,
                torch.as_tensor(tags0, device=dev),
                torch.as_tensor(vals0, device=dev))
        t0 = time.monotonic()
        got = taint_chunk_cuda(*args, k=kk, may_latch=True)
        torch.cuda.synchronize()
        ref = taint_chunk(*args, k=kk, may_latch=True)
        max_err = max(max_err, compare_chunk(torch, got, ref, label))
        n_det, n_ovf = int(got[3].sum()), int(got[7].sum())
        log(f"K2 vs plain {label}: {N_CHUNK_MIXED} lanes ({int(carried.sum())}"
            f" carried) on chunk {last} of S={CHUNK_SMALL} ({n_real} µops"
            f" + {CHUNK_SMALL - n_real} NOPs) equal, {n_det} detected, "
            f"{int(got[4].sum())} trapped, {n_ovf} overflowed "
            f"({time.monotonic() - t0:.1f} s)")
        if kk == k and n_det == 0:
            fail("the mixed-kind chunk batch detected no fault")
        if kk == 4 and n_ovf == 0:
            fail("the K=4 chunk batch overflowed no set")
    # (d) the same chunk and lanes with one loud step: its middle branch's
    # outcome inverted before recording
    taken_d, j_d = loud_branch(tr_s.taken.cpu().numpy(),
                               tr_s.opcode.cpu().numpy())
    tr_d = tr_s._replace(taken=torch.as_tensor(taken_d, device=dev))
    gold_d = record_chunk(tr_d, reg0_s, torch.as_tensor(
        small.gb_mem[last].astype(np.int64), device=dev), gold_s.final_reg,
        gold_s.final_mem)
    loud_d = torch.nonzero(~taint_cuda.quiet_steps(gold_d, tr_d)
                           ).flatten().tolist()
    if loud_d != [j_d]:
        fail(f"K2 (d): loud steps {loud_d[:8]}, expected [{j_d}]")
    tags0, vals0 = seeded_sets(carried, k, trace.nphys, trace.mem_words, 23)
    args = (gold_d, tr_d, cov_s, mixed,
            *setup_gather(gold_d, tr_d, reg0_s, mixed),
            torch.as_tensor(tags0, device=dev),
            torch.as_tensor(vals0, device=dev))
    t0 = time.monotonic()
    got = taint_chunk_cuda(*args, k=k, may_latch=True)
    torch.cuda.synchronize()
    ref = taint_chunk(*args, k=k, may_latch=True)
    max_err = max(max_err, compare_chunk(torch, got, ref, "(d) loud step"))
    n_stop = int((got[2] == j_d + 1).sum())
    log(f"K2 vs plain (d) loud step {j_d}: {N_CHUNK_MIXED} lanes equal, "
        f"{n_stop} stopped there ({time.monotonic() - t0:.1f} s)")
    if n_stop == 0:
        fail("K2 (d): no lane stopped at the loud step")
    marks("8 K2 vs plain")

    # 9. the chunked main path, counted; each K2 launch's inputs and result
    # are kept for batch (a) and the timings
    exact_log: list = []
    run_exact = camp._outcomes_exact

    def timed_exact(f_host, outcomes, land_chunk, st):
        torch.cuda.synchronize()
        t0, w0 = time.monotonic(), st["waves"]
        run_exact(f_host, outcomes, land_chunk, st)
        torch.cuda.synchronize()
        exact_log.append((time.monotonic() - t0, int(land_chunk.size),
                          st["waves"] - w0))

    camp._outcomes_exact = timed_exact
    plain_calls = [0]

    def counted_plain(*a, **kw):
        plain_calls[0] += 1
        return taint_chunk(*a, **kw)

    main_waves: list = []

    def plain_kw(kw):
        """A K2 call's keywords as its plain version takes them (no
        packed stream)."""
        return {x: v for x, v in kw.items() if x != "stream"}

    def kept_launch(*a, **kw):
        got = taint_chunk_cuda(*a, **kw)
        main_waves.append((a, kw, got))
        return got

    CH.taint_chunk_cuda = kept_launch
    taint_cuda.taint_chunk = counted_plain
    taint_chunk_cuda.launches = 0
    t0 = time.monotonic()
    out = camp.outcomes_from_keys(keys, "regfile")
    torch.cuda.synchronize()
    t_main = time.monotonic() - t0
    launches = taint_chunk_cuda.launches
    CH.taint_chunk_cuda = taint_chunk_cuda
    st = dict(camp.last_stats)
    fast_waves = st["waves"] - sum(x[2] for x in exact_log)
    if launches < 1 or launches != fast_waves:
        fail(f"{launches} K2 launches for {fast_waves} fast waves")
    if plain_calls[0]:
        fail(f"the main path called the plain chunk scan {plain_calls[0]} "
             f"times")
    tally = np.bincount(out, minlength=C.N_OUTCOMES).tolist()
    log(f"main path outcomes_from_keys({N_CHUNK_KEYS}, 'regfile') at "
        f"S={CHUNK}: tally {tally}, {launches} K2 launch(es) for "
        f"{fast_waves} fast waves, 0 plain calls, stats {st}, "
        f"{t_main:.1f} s")
    # (a) K2 against its plain version on each of the main path's waves
    plain_wave_ms = []
    for w, (a, kw, got) in enumerate(main_waves):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ref = taint_chunk(*a, **plain_kw(kw))
        end.record()
        end.synchronize()
        plain_wave_ms.append(start.elapsed_time(end))
        max_err = max(max_err, compare_chunk(torch, got, ref,
                                             f"(a) main-path wave {w}"))
        lanes = wave_lanes(a[3], a[7], CHUNK)
        log(f"K2 vs plain (a) main-path wave {w}: {a[3].kind.shape[0]} "
            f"lanes ({int(lanes[0].sum())} landing, {int(lanes[1].sum())} "
            f"carried in, {int(lanes[2].sum())} null) equal, "
            f"{int(got[6].sum())} escaped, "
            f"{int((got[3] | got[4] | got[5]).sum())} frozen; plain "
            f"{plain_wave_ms[-1] / 1e3:.1f} s")
    gate_keys = prng.trial_keys(prng.campaign_key(GATE_SEED, dev), N_GATE)
    fast = ChunkedCampaign(kernel, chunk=CHUNK, engine="taint")
    exact = ChunkedCampaign(kernel, chunk=CHUNK, engine="exact")
    o_fast = fast.outcomes_from_keys(gate_keys, "regfile")
    o_exact = exact.outcomes_from_keys(gate_keys, "regfile")
    if not np.array_equal(o_fast, o_exact):
        fail(f"gate (i): taint and exact engines differ on "
             f"{int((o_fast != o_exact).sum())}/{N_GATE} keys")
    oracle = kernel.oracle_outcomes(faults)
    if not np.array_equal(out, oracle):
        fail(f"gate (ii): {int((out != oracle).sum())}/{N_CHUNK_KEYS} "
             f"outcomes differ from the C++ oracle")
    got_pin = "".join(map(str, o_fast.tolist()))
    if got_pin != PIN_CHUNKED:
        fail(f"gate (iii): taint outcomes {got_pin} != JAX reference "
             f"{PIN_CHUNKED}")
    hz_fast = ChunkedCampaign(kernel, chunk=CHUNK_HORIZON, carry_horizon=2,
                              engine="taint")
    hz_exact = ChunkedCampaign(kernel, chunk=CHUNK_HORIZON,
                               carry_horizon=2, engine="exact")
    o_hf = hz_fast.outcomes_from_keys(gate_keys, "regfile")
    o_he = hz_exact.outcomes_from_keys(gate_keys, "regfile")
    if not np.array_equal(o_hf, o_he):
        fail(f"gate (iv): at S={CHUNK_HORIZON}, horizon 2 the engines "
             f"differ on {int((o_hf != o_he).sum())}/{N_GATE} keys")
    if hz_fast.last_stats["carried"] < 1:
        fail(f"gate (iv): no lane was carried at S={CHUNK_HORIZON}")
    if plain_calls[0]:
        fail("the gates called the plain chunk scan")
    log(f"gates: (i) taint == exact on {N_GATE} keys, (ii) "
        f"{N_CHUNK_KEYS} outcomes == C++ oracle, (iii) == JAX pin, (iv) "
        f"S={CHUNK_HORIZON} horizon 2 taint == exact, "
        f"{hz_fast.last_stats['carried']} carried")
    marks("9 chunked main path + gates")

    # 10. timings
    def host_ms(fn):
        fn()
        times = []
        for _ in range(REPS_CHUNKED):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            times.append((time.monotonic() - t0) * 1e3)
        return statistics.median(times)

    # outcomes_from_keys and its exact fallback: phase 9's counted run,
    # timed there (a second run only to time it took 15-25 s)
    e2e_ms = t_main * 1e3
    # the exact fallback inside that run (none: 0 lanes, 0 ms)
    fb_ms = statistics.median([x[0] * 1e3 for x in exact_log] or [0.0])
    fb_lanes = exact_log[-1][1] if exact_log else 0
    k2_wave_ms = [time_ms(torch, lambda a=a, kw=kw: taint_chunk_cuda(*a, **kw),
                          REPS_CHUNKED) for a, kw, _ in main_waves]
    rec_ms = time_ms(torch, lambda: camp.chunk_record(0), REPS_CHUNKED)
    a0 = main_waves[0][0]
    reg00 = torch.as_tensor(win.gb_reg[0].astype(np.int64), device=dev)
    setup_ms = time_ms(torch, lambda: setup_gather(a0[0], a0[1], reg00,
                                                   a0[3]), REPS_CHUNKED)

    def rebuild():
        W.clear_registry()
        preprocess_window(kernel, CHUNK)

    pre_ms = host_ms(rebuild)
    if plain_calls[0]:
        fail("the timed main path called the plain chunk scan")
    taint_cuda.taint_chunk = taint_chunk

    # K2's bound over the main path's waves, counted as K1's: the
    # function's own need (need_operations, from the kernel's hit counts;
    # the kernels line's), and the full body over the steps the chunk
    # function needs (k2_operations: from a lane's landing, or step 0 for
    # a lane carrying a set in); bytes with the seeds in and the sets out
    bound = {"ops": [], "full_lane_steps": [], "untouched_lane_steps": [],
             "untouched_ops": [], "ops_from_landing": [],
             "needed_lane_steps": [], "bytes": [], "ops_ms": [],
             "bytes_ms": [], "from_landing_ms": [], "longest_walk": [],
             "ns_per_step": []}
    for w, ((a, kw, got), ms) in enumerate(zip(main_waves, k2_wave_ms)):
        B = a[3].kind.shape[0]
        opcode = a[1].opcode.cpu().numpy()
        steps = got[2].cpu().numpy()
        ops_landing, needed = k2_operations(opcode, a[3], a[7], steps, k)
        counts = torch.zeros((2, B), dtype=torch.int32, device=dev)
        taint_chunk_cuda(*a, **kw, counts=counts)
        loud = (~taint_cuda.quiet_steps(a[0], a[1])).cpu().numpy()
        landing = wave_lanes(a[3], a[7], CHUNK)[0]
        land = np.where(landing, a[3].cycle.cpu().numpy(), -1)
        ops, full_steps, untouched = need_operations(
            opcode, loud, land, steps, counts.cpu().numpy(), k)
        walk = int((got[2].to(torch.int64) - taint_cuda.lane_starts(
            a[3], CHUNK, a[7])).max())
        bytes_moved = (16 * CHUNK * 4 + B * 8 * 4 + 2 * k * B * 4
                       + B * 4 * 4 + 2 * k * B * 4)
        for key, v in (("ops", ops), ("full_lane_steps", full_steps),
                       ("untouched_lane_steps", untouched),
                       ("untouched_ops", untouched * OPS_UNTOUCHED),
                       ("ops_from_landing", ops_landing),
                       ("needed_lane_steps", needed),
                       ("bytes", bytes_moved),
                       ("ops_ms", ops / H100_INT32_OPS_PER_S * 1e3),
                       ("bytes_ms", bytes_moved / H100_BYTES_PER_S * 1e3),
                       ("from_landing_ms",
                        ops_landing / H100_INT32_OPS_PER_S * 1e3),
                       ("longest_walk", walk),
                       ("ns_per_step", ms * 1e6 / max(walk, 1))):
            bound[key].append(v)
        log(f"K2 wave {w}: {ms:.3f} ms, longest walk {walk} steps, "
            f"{ms * 1e6 / max(walk, 1):.1f} ns per step on it; bound "
            f"{max(bound['ops_ms'][-1], bound['bytes_ms'][-1]):.4f} ms "
            f"({full_steps} full lane-steps; {untouched} untouched "
            f"lane-steps walked), {bound['from_landing_ms'][-1]:.4f} ms "
            f"counting the full body from each landing")
    bound_ms = sum(max(o, b) for o, b in zip(bound["ops_ms"],
                                             bound["bytes_ms"]))
    by_ops = sum(bound["ops_ms"]) >= sum(bound["bytes_ms"])
    timings = {
        "chunked_outcomes_ms": e2e_ms,
        "chunked_trials_per_s": N_CHUNK_KEYS / (e2e_ms / 1e3),
        "k2_ms": sum(k2_wave_ms), "k2_wave_ms": k2_wave_ms,
        "k2_plain_ms": sum(plain_wave_ms), "k2_plain_wave_ms": plain_wave_ms,
        "k2_bound_ms": bound_ms,
        "k2_waves": [[CHUNK, a[3].kind.shape[0]] for a, _, _ in main_waves],
        **{f"k2_{key}": v for key, v in bound.items()},
        "record_chunk_ms": rec_ms, "setup_gather_ms": setup_ms,
        "exact_fallback_ms": fb_ms, "exact_fallback_lanes": fb_lanes,
        "preprocess_ms": pre_ms, "main_stats": st}
    # ms, plain_ms and bound_ms cover the main path's K2 launches together
    record = {
        "name": "taint_chunk", "route": "cuda",
        "source": "shrewd_tpu_torch/csrc/taint_fast.cu",
        "replaces": "shrewd_tpu/ops/pallas_taint.py:634",
        "launches": launches, "max_abs_err": float(max_err),
        "matches_plain": max_err == 0,
        "ms": sum(k2_wave_ms), "plain_ms": sum(plain_wave_ms),
        "bound_ms": bound_ms,
        "bound_by": "operations" if by_ops else "bytes",
        "library_ms": None}
    marks("10 chunked timings")
    return timings, record


def structure_lanes(faults, n: int) -> dict:
    """Counts of a batch's lanes that land nowhere: the wrong-path
    sentinel (entry == n) and pipeline bubbles (entry < 0 or > n)."""
    entry = faults.entry.cpu().numpy().astype(np.int64)
    return {"sentinel": int((entry == n).sum()),
            "bubble": int(((entry < 0) | (entry > n)).sum())}


def structure_phases(torch, dev, marks, kernel, keys, card) -> dict:
    """Phases 11-12 on the flagship window's fupool kernel → the timings
    and K1's and K2's launches on each path."""
    from shrewd_tpu_torch import native
    from shrewd_tpu_torch.models.o3 import STRUCTURES, O3Config
    from shrewd_tpu_torch.ops import classify as C
    from shrewd_tpu_torch.ops import taint_cuda
    from shrewd_tpu_torch.ops.chunked import ChunkedCampaign
    from shrewd_tpu_torch.ops.taint import taint_chunk
    from shrewd_tpu_torch.ops.taint_cuda import (taint_chunk_cuda,
                                                 taint_fast_cuda)
    from shrewd_tpu_torch.ops.trial import TrialKernel
    from shrewd_tpu_torch.parallel import ShardedCampaign, run_until_ci
    from shrewd_tpu_torch.utils import prng

    plain_calls = [0]
    plain = taint_cuda.taint_fast_plain

    def counted_plain(*a, **kw):
        plain_calls[0] += 1
        return plain(*a, **kw)

    taint_cuda.taint_fast_plain = counted_plain
    timings: dict = {"card": card}
    launches: dict = {}
    max_err = 0

    # 11. the structure path
    log("FU pool availability (fupool under the scoreboard's schedule): "
        + json.dumps(kernel.fu_model.availability()))
    log("FU pool availability with wrong-path phantoms: "
        + json.dumps(kernel.fu_model.availability(include_phantoms=True)))
    for s in ("fu", "rob", "iq", "lsq", "latch"):
        t0 = time.monotonic()
        kernel.escapes = 0
        taint_fast_cuda.launches = 0
        tally = kernel.run_keys(keys, s)
        torch.cuda.synchronize()
        n_launch = taint_fast_cuda.launches
        t_main = time.monotonic() - t0
        escapes = kernel.escapes
        tally = tally.tolist()
        if n_launch != 1:
            fail(f"{s}: run_keys launched K1 {n_launch} times, not once")
        if plain_calls[0]:
            fail(f"{s}: run_keys called K1's plain version")
        if sum(tally) != N_KEYS:
            fail(f"{s}: tally {tally} sums to {sum(tally)}, not {N_KEYS}")
        sub = kernel.sample_batch(keys[:N_ORACLE], s)
        if sub.kind.device.type != "cuda":
            fail(f"{s}: faults drawn on {sub.kind.device}")
        hybrid = kernel.run_batch_hybrid(sub, may_latch=s == "latch")
        pin = np.bincount(hybrid[:N_PIN_S], minlength=C.N_OUTCOMES).tolist()
        if pin != PIN_STRUCTURES[s]:
            fail(f"{s}: first {N_PIN_S} keys: tally {pin} != JAX reference "
                 f"{PIN_STRUCTURES[s]}")
        oracle = kernel.oracle_outcomes(sub)
        bad = int((hybrid != oracle).sum())
        if bad:
            fail(f"{s}: {bad}/{N_ORACLE} outcomes differ from the C++ "
                 f"oracle")
        # K1 against its plain version on every lane the path drew, at the
        # path's own launch shape (its block size follows the batch)
        faults = kernel.sample_batch(keys, s)
        args = (kernel.golden_rec, kernel.tr, kernel.shadow_cov, faults,
                *kernel._setup_batch(faults))
        kw = dict(k=kernel.cfg.taint_k, compare_regs=kernel.cfg.compare_regs,
                  may_latch=s == "latch")
        t0 = time.monotonic()
        got = taint_fast_cuda(*args, **kw, stream=kernel.packed_stream)
        torch.cuda.synchronize()
        max_err = max(max_err, compare(torch, got, plain(*args, **kw),
                                       f"{s} at full width"))
        t_plain = time.monotonic() - t0
        del got
        # the counted run's own time (a second run only to time it cost
        # 4-6 s a structure)
        run_ms = t_main * 1e3
        k1_ms = time_ms(torch, lambda: taint_fast_cuda(
            *args, **kw, stream=kernel.packed_stream))
        if plain_calls[0]:
            fail(f"{s}: the K1 timing called K1's plain version")
        lanes = structure_lanes(faults, kernel.trace.n)
        launches[f"run_keys {s}"] = n_launch
        timings[f"run_keys_{s}"] = {
            "tally": tally, "ms": run_ms,
            "trials_per_s": N_KEYS / (run_ms / 1e3), "k1_ms": k1_ms,
            "escapes_resolved": escapes, **lanes}
        log(f"{s}: run_keys({N_KEYS}) tally {tally}, 1 K1 launch, 0 plain "
            f"calls, first {N_PIN_S} keys == JAX pin, {N_ORACLE} outcomes "
            f"== C++ oracle, K1 == plain on all {N_KEYS} lanes ("
            f"{t_plain:.1f} s); {lanes['sentinel']} sentinel and "
            f"{lanes['bubble']} bubble lanes; {run_ms:.1f} ms = "
            f"{N_KEYS / (run_ms / 1e3):,.0f} trials/s (the counted run), K1 "
            f"{k1_ms:.3f} ms ({card}; {escapes} escaped lanes resolved)")
    marks("11 structure path")

    # 12. the campaign loop
    order = list(STRUCTURES)
    for s in ("regfile", "fu"):
        pin = PIN_CI[s]
        kernel.escapes = 0
        taint_fast_cuda.launches = 0
        r = run_until_ci(ShardedCampaign(kernel, None, s, stratify=True),
                         seed=0, simpoint_id=0, structure_id=order.index(s),
                         batch_size=CI_BATCH, target_halfwidth=CI_TARGET)
        n_launch = taint_fast_cuda.launches
        if not r.converged:
            fail(f"run_until_ci {s}: not converged after {r.trials} trials")
        if n_launch != r.batches:
            fail(f"run_until_ci {s}: {n_launch} K1 launches for "
                 f"{r.batches} batches")
        if plain_calls[0]:
            fail(f"run_until_ci {s}: called K1's plain version")
        got = dict(tallies=r.tallies.tolist(), trials=r.trials,
                   batches=r.batches, strata=r.strata_tallies.tolist())
        want = {key: pin[key] for key in got}
        if got != want:
            fail(f"run_until_ci {s}: {got} != JAX reference {want}")
        err = max(abs(a - b) for a, b in zip(r.avf_interval,
                                             pin["avf_interval"]))
        if err > 1e-12:
            fail(f"run_until_ci {s}: interval {tuple(r.avf_interval)} != "
                 f"JAX reference {pin['avf_interval']}")
        launches[f"run_until_ci {s}"] = n_launch
        timings[f"run_until_ci_{s}"] = {
            "tallies": got["tallies"], "trials": r.trials,
            "batches": r.batches, "avf_interval": list(r.avf_interval),
            "wall_s": r.wall_seconds, "trials_per_s": r.trials_per_second,
            "escapes": kernel.escapes}
        log(f"run_until_ci {s}: converged, {r.batches} batch(es) of "
            f"{CI_BATCH}, tallies {got['tallies']}, AVF interval "
            f"{tuple(r.avf_interval)} == JAX pins, {n_launch} K1 launch(es)"
            f"; {r.trials_per_second:,.0f} trials/s, {kernel.escapes} "
            f"unresolved lanes ({card})")
    taint_cuda.taint_fast_plain = plain
    # the chunked route, untimed: fu keys on the chunked window
    trace16 = native.generate_trace(**CHUNK_WINDOW)
    t0 = time.monotonic()
    k16 = TrialKernel(trace16, O3Config(shadow_model="fupool"), device=dev)
    t_build = time.monotonic() - t0
    camp = ChunkedCampaign(k16, chunk=CHUNK)
    keys16 = prng.trial_keys(prng.campaign_key(CHUNK_SEED, dev), N_CHUNK_FU)
    # as phase 9: the exact fallback's waves counted apart and the plain
    # chunk scan counted.  K2 is held against its plain version on the
    # chunked main path's own waves (phase 9) and on mixed kinds (phase 8),
    # so not again on this route: a plain 32768-step wave took 34-36 s
    exact_waves = [0]
    run_exact = camp._outcomes_exact

    def counted_exact(f_host, outcomes, land_chunk, st):
        w0 = st["waves"]
        run_exact(f_host, outcomes, land_chunk, st)
        exact_waves[0] += st["waves"] - w0

    chunk_plain = [0]

    def counted_chunk_plain(*a, **kw):
        chunk_plain[0] += 1
        return taint_chunk(*a, **kw)

    camp._outcomes_exact = counted_exact
    taint_cuda.taint_chunk = counted_chunk_plain
    taint_chunk_cuda.launches = 0
    t0 = time.monotonic()
    tally = ShardedCampaign(k16, None, "fu", chunked=camp).tally_batch(
        keys16).tolist()
    torch.cuda.synchronize()
    t_route = time.monotonic() - t0
    n_launch = taint_chunk_cuda.launches
    taint_cuda.taint_chunk = taint_chunk
    fast_waves = camp.last_stats["waves"] - exact_waves[0]
    if n_launch < 1 or n_launch != fast_waves:
        fail(f"chunked route fu: {n_launch} K2 launches for {fast_waves} "
             f"fast waves")
    if chunk_plain[0]:
        fail(f"chunked route fu: called the plain chunk scan "
             f"{chunk_plain[0]} times")
    oracle = np.bincount(k16.oracle_outcomes(k16.sample_batch(keys16, "fu")),
                         minlength=C.N_OUTCOMES).tolist()
    if tally != oracle:
        fail(f"chunked route fu: tally {tally} != C++ oracle {oracle}")
    launches["chunked tally_batch fu"] = n_launch
    timings["chunked_fu"] = {"tally": tally, "stats": camp.last_stats,
                             "kernel_build_s": t_build}
    log(f"chunked route: tally_batch({N_CHUNK_FU} fu keys) at S={CHUNK} "
        f"tally {tally} == C++ oracle, {n_launch} K2 launch(es) for "
        f"{fast_waves} fast waves, 0 plain calls, stats {camp.last_stats}; "
        f"fupool kernel on {trace16.n} µops built in {t_build:.1f} s, route "
        f"{t_route:.1f} s")
    marks("12 campaign loop")
    return {"timings": timings, "launches": launches, "k1_max_err": max_err}


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def stop_record(st, target: float, plan) -> dict | None:
    """The result a serial campaign at ``target`` (the plan's confidence
    and min_trials otherwise) would stop with, if the stratified rule
    fires on the cumulative state ``st`` (an orchestrator's ``_State``),
    else None: read off a run at a tighter target, which passes through
    the same batches."""
    from shrewd_tpu_torch.parallel import stopping

    pairs = stopping.pairs_from_strata(st.strata)
    if not stopping.should_stop_stratified(pairs, target, plan.confidence,
                                           plan.min_trials):
        return None
    return dict(tallies=st.tallies.tolist(), trials=st.trials,
                batches=st.next_batch, strata=st.strata.tolist(),
                avf_interval=tuple(stopping.post_stratified(
                    pairs, plan.confidence)))


def cli_phase(torch, marks, card) -> dict:
    """Phase 13, the campaign CLI on the flagship window → the timings,
    K1's launches on each run and K1's largest difference from its plain
    version on the runs' own batches.  The CLI's own decision to stop is
    checked at target 0.005 (runs (b) and (c)); the 0.01 gate (a) is
    computed here, by ``stop_record`` applying the stratified stopping rule
    to the orchestrator's state after each regfile batch of run (c)."""
    import os
    import shutil
    import tempfile
    import warnings

    from shrewd_tpu_torch import native
    from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
    from shrewd_tpu_torch.campaign.plan import CampaignPlan, TraceFileSpec
    from shrewd_tpu_torch.main import main as cli
    from shrewd_tpu_torch.models.o3 import KIND_FU, KIND_REGFILE, O3Config
    from shrewd_tpu_torch.ops import taint_cuda, trial
    from shrewd_tpu_torch.ops.taint_cuda import taint_fast_cuda
    from shrewd_tpu_torch.ops.trial import TrialKernel
    from shrewd_tpu_torch.trace import format as tf
    from shrewd_tpu_torch.utils import prng

    # instrumentation: the lane count of every K1 launch (batches,
    # canaries and audit samples differ in it), the first batch launch of
    # each structure kept for the comparison with the plain version, and
    # any call of the plain version on card tensors
    sizes: list = []
    kept: dict = {}
    launch = trial.taint_fast_cuda

    def sized(*a, **kw):
        got = launch(*a, **kw)
        n = int(a[3].kind.shape[0])
        sizes.append(n)
        kind = int(a[3].kind[0])
        if n == CI_BATCH and kind not in kept:
            kept[kind] = (a, {x: v for x, v in kw.items() if x != "stream"},
                          got)
        return got

    plain_cuda = [0]
    plain = taint_cuda.taint_fast_plain

    def counted_plain(*a, **kw):
        if a[3].kind.device.type == "cuda":
            plain_cuda[0] += 1
        return plain(*a, **kw)

    trial.taint_fast_cuda = sized
    taint_cuda.taint_fast_plain = counted_plain
    timings: dict = {"card": card}
    launches: dict = {}
    d = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    trace = native.generate_trace(**FLAGSHIP)
    npz = os.path.join(d, "flagship.npz")
    tf.save(npz, trace, meta={"source": "native.generate_trace",
                              **FLAGSHIP})

    def plan_file(name: str, target: float, **kw) -> str:
        plan = CampaignPlan(
            simpoints=[TraceFileSpec(name="flagship", path=npz)],
            structures=["regfile", "fu"], batch_size=CI_BATCH,
            target_halfwidth=target, stratify=True,
            machine=O3Config(shadow_model="fupool"), **kw)
        path = os.path.join(d, name)
        plan.dump_json(path)
        return path

    def check(tag: str, out: str, pins: dict, n_dev: int, n0: int,
              exact: bool, mon0: dict) -> dict:
        """The gates of one finished run, from its final checkpoint and
        stats.json; ``n_dev`` the 4096-lane K1 launches it made, ``n0``
        the batches believed before it and ``mon0`` the integrity
        counters it resumed with (a resumed run)."""
        doc = _read_json(os.path.join(out, "campaign_ckpt",
                                      "campaign.json"))
        stats = _read_json(os.path.join(out, "stats.json"))
        batches = 0
        for s, pin in pins.items():
            st = doc["state"]["flagship"][s]
            got = dict(tallies=st["tallies"], trials=sum(st["tallies"]),
                       batches=st["next_batch"], strata=st["strata"])
            if got != pin or not st["converged"]:
                fail(f"{tag} {s}: {got} (converged {st['converged']}) != "
                     f"JAX reference {pin}")
            if st["tier_trials"] != [pin["trials"], 0, 0]:
                fail(f"{tag} {s}: tier trials {st['tier_trials']}: a batch "
                     "ran below the device tier")
            batches += pin["batches"]
        tiers = stats["resilience"]["tier_trials"]
        if tiers["cpu"] or tiers["oracle"]:
            fail(f"{tag}: resilience.tier_trials {tiers}")
        ig = stats["integrity"]
        bad = {k: ig[k] for k in ("canary_failures", "invariant_violations",
                                  "audit_mismatches", "quarantined_batches")
               if ig[k]}
        if bad:
            fail(f"{tag}: integrity counters {bad}")
        mon = {k: doc["integrity"][k] - mon0.get(k, 0)
               for k in ("canary_runs", "audit_batches")}
        want = {CI_BATCH: n_dev, 3: mon["canary_runs"], 2: mon["canary_runs"],
                64: mon["audit_batches"]}
        got = {n: sizes.count(n) for n in set(sizes) | set(want)}
        if got != want or taint_fast_cuda.launches != len(sizes):
            fail(f"{tag}: K1 launches by lane count {got} != the batches, "
                 f"canaries and audit samples {want} (counter "
                 f"{taint_fast_cuda.launches})")
        if (n_dev != batches - n0) if exact else (n_dev < batches - n0):
            fail(f"{tag}: {n_dev} batch launches for {batches - n0} "
                 "believed batches")
        if plain_cuda[0]:
            fail(f"{tag}: K1's plain version ran on card tensors")
        return {"rc": 0, "batches": batches - n0, "k1_launches": len(sizes),
                "k1_batch_launches": n_dev, "canary_runs": mon["canary_runs"],
                "audit_batches": mon["audit_batches"],
                "perf": {k: stats["perf"][k] for k in (
                    "intervals", "super_intervals", "serial_fallbacks",
                    "host_roundtrips_saved", "auto_sync_every",
                    "dispatch_depth", "device_step_seconds",
                    "device_wait_seconds")}}

    def run(tag: str, argv: list, pins: dict, exact: bool = True,
            n0: int = 0, mon0: dict | None = None,
            syncs: bool = False) -> dict:
        sizes.clear()
        taint_fast_cuda.launches = 0
        t0 = time.monotonic()
        with warnings.catch_warnings(record=True) as caught:
            if syncs:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
            try:
                rc = cli(argv)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        if rc != 0:
            fail(f"{tag}: CLI rc {rc}")
        res = check(tag, argv[argv.index("--outdir") + 1], pins,
                    sizes.count(CI_BATCH), n0, exact, mon0 or {})
        # the trials this run believed (a resumed run's own batches)
        res.update(wall_s=wall,
                   trials_per_s=res["batches"] * CI_BATCH / wall)
        if syncs:
            res["host_syncs"] = sum("synchroniz" in str(w.message)
                                    for w in caught)
        launches[f"campaign CLI {tag}"] = res["k1_launches"]
        timings[f"cli_{tag.replace(' ', '_')}"] = res
        log(f"CLI {tag}: rc 0, results == JAX pins, every batch on the "
            f"device tier, integrity clean, K1 {res['k1_launches']} "
            f"launches = {res['k1_batch_launches']} batches + "
            f"2 x {res['canary_runs']} canary runs + "
            f"{res['audit_batches']} audit samples, 0 plain calls; "
            f"{wall:.1f} s = {res['trials_per_s']:,.0f} trials/s ({card})")
        return res

    t_phase = time.monotonic()
    plan005 = plan_file("plan005.json", CLI_TARGET)
    # (b) target 0.005, three ways, the serial run's host syncs counted
    serial = run("(b) serial", ["run", plan005, "--outdir",
                                os.path.join(d, "b0")], PIN_CLI,
                 syncs=True)
    sync = run("(b) sync-every 4", [
        "run", plan005, "--outdir", os.path.join(d, "b1"), "--sync-every",
        "4", "--pipeline-depth", "2"], PIN_CLI, exact=False)
    until = run("(b) until-CI", ["run", plan005, "--outdir",
                                 os.path.join(d, "b2"), "--until-ci"],
                PIN_CLI)
    if until["batches"] != serial["batches"]:
        fail(f"until-CI consumed {until['batches']} batches, the serial "
             f"loop {serial['batches']}")
    if sync["perf"]["intervals"] < 1 or until["perf"]["super_intervals"] < 1:
        fail(f"the interval or until-CI engine never ran: {sync['perf']}, "
             f"{until['perf']}")
    # (c) a serial run stopped after its third batch, then resumed
    planc = plan_file("planc.json", CLI_TARGET, checkpoint_every=1)
    sizes.clear()
    taint_fast_cuda.launches = 0
    orch = Orchestrator(CampaignPlan.from_dict(_read_json(planc)),
                        outdir=os.path.join(d, "c"))
    # (a) target 0.01, read off this run's regfile batches: the stratified
    # rule at 0.01 first fires after PIN_CI's batches, on PIN_CI's
    # tallies, strata and interval (fu's 0.01 pin is its 0.005 one)
    seen = 0
    at01 = None
    for ev, info in orch.events():
        if ev.name == "BATCH_COMPLETE":
            seen += 1
            if info.structure == "regfile" and at01 is None:
                at01 = stop_record(orch.state[("flagship", "regfile")],
                                   CI_TARGET, orch.plan)
            if seen == 3:
                orch.request_drain()
        if ev.name == "PREEMPTED":
            break
    if not orch.preempted or seen != 3:
        fail(f"(c): the run did not stop after its third batch ({seen})")
    pin01 = PIN_CI["regfile"]
    if at01 is None or any(at01[k] != pin01[k] for k in (
            "tallies", "trials", "batches", "strata")) or max(
            abs(x - y) for x, y in zip(at01["avf_interval"],
                                       pin01["avf_interval"])) > 1e-12:
        fail(f"(a): the CLI's regfile at target 0.01 stops at {at01}, not "
             f"at the JAX reference's {pin01}")
    log(f"(a) target 0.01, read off run (c): regfile stops after "
        f"{at01['batches']} batches == PIN_CI; fu's 0.01 pin is its 0.005 "
        "one")
    first = len(sizes)
    if first != 3 + 3 * 3:
        fail(f"(c): {first} K1 launches in the first 3 batches, not 3 "
             "batches + 3 x (2 canaries + 1 audit sample)")
    launches["campaign CLI (c) first 3 batches"] = first
    ckpt_c = os.path.join(d, "c", "campaign_ckpt")
    resumed = run("(c) resume", ["resume", ckpt_c, "--outdir",
                                 os.path.join(d, "c2")], PIN_CLI, n0=3,
                  mon0=_read_json(os.path.join(ckpt_c,
                                               "campaign.json"))["integrity"])
    # the host syncs of one bare batch step
    kernel = TrialKernel(trace, O3Config(shadow_model="fupool"))
    keys = prng.trial_keys(prng.campaign_key(0), CI_BATCH)
    kernel.tally_on_device(keys, "regfile")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            kernel.tally_on_device(keys, "regfile")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    step_syncs = sum("synchroniz" in str(w.message) for w in caught)
    # K1 against its plain version on the first batch launch of each
    # structure, at the main path's shape
    max_err = 0
    for kind, name in ((KIND_REGFILE, "regfile"), (KIND_FU, "fu")):
        if kind not in kept:
            fail(f"no {CI_BATCH}-lane K1 launch of {name} was kept")
        args, kw, got = kept[kind]
        max_err = max(max_err, compare(torch, got, plain(*args, **kw),
                                       f"CLI {name} batch"))
    trial.taint_fast_cuda = launch
    taint_cuda.taint_fast_plain = plain
    timings["cli_host_syncs"] = {
        "run_b_serial": serial["host_syncs"],
        "run_b_serial_batches": serial["batches"],
        "per_batch_all_layers": serial["host_syncs"] / serial["batches"],
        "bare_batch_step": step_syncs}
    timings["cli_phase_s"] = time.monotonic() - t_phase
    log(f"host syncs: {serial['host_syncs']} in run (b) serial = "
        f"{serial['host_syncs'] / serial['batches']:.1f} per batch with "
        f"canaries, audit and checks; {step_syncs} in one bare batch step "
        f"(tally_on_device)")
    log(f"perf: sync-every 4 {sync['perf']}; until-CI {until['perf']}")
    shutil.rmtree(d, ignore_errors=True)
    log(f"(c): stopped after 3 batches ({first} K1 launches), resumed to "
        f"the pins; K1 == plain on the regfile and fu batch launches; "
        f"phase 13 {timings['cli_phase_s']:.1f} s ({card})")
    launches["campaign CLI (c) resume"] = resumed["k1_launches"]
    marks("13 campaign CLI")
    return {"timings": timings, "launches": launches, "k1_max_err": max_err}


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_phase(torch, marks, card) -> dict:
    """Phase 15, multi-device campaigns on the one card → the timings,
    K1's launches on each run and K1's largest difference from its plain
    version on run (a)'s first batch."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    from shrewd_tpu_torch import native
    from shrewd_tpu_torch.campaign.plan import CampaignPlan, TraceFileSpec
    from shrewd_tpu_torch.main import main as cli
    from shrewd_tpu_torch.models.o3 import O3Config
    from shrewd_tpu_torch.ops import taint_cuda, trial
    from shrewd_tpu_torch.ops.taint_cuda import taint_fast_cuda
    from shrewd_tpu_torch.parallel.mesh import make_mesh
    from shrewd_tpu_torch.trace import format as tf

    t_phase = time.monotonic()
    timings: dict = {"card": card}
    launches: dict = {}
    d = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    npz = os.path.join(d, "flagship.npz")
    tf.save(npz, native.generate_trace(**FLAGSHIP),
            meta={"source": "native.generate_trace", **FLAGSHIP})

    def plan_file(name: str, target: float, **kw) -> str:
        path = os.path.join(d, name)
        CampaignPlan(
            simpoints=[TraceFileSpec(name="flagship", path=npz)],
            structures=["regfile", "fu"], batch_size=CI_BATCH,
            target_halfwidth=target, stratify=True,
            machine=O3Config(shadow_model="fupool"), **kw).dump_json(path)
        return path

    # (a) the collective mesh over a one-rank NCCL group
    sizes: list = []
    kept: list = []
    launch = trial.taint_fast_cuda

    def sized(*a, **kw):
        got = launch(*a, **kw)
        sizes.append(int(a[3].kind.shape[0]))
        if sizes[-1] == CI_BATCH and not kept:
            kept.append((a, {x: v for x, v in kw.items() if x != "stream"},
                         got))
        return got

    plain_cuda = [0]
    plain = taint_cuda.taint_fast_plain

    def counted_plain(*a, **kw):
        if a[3].kind.device.type == "cuda":
            plain_cuda[0] += 1
        return plain(*a, **kw)

    reduces: list = []
    all_reduce = dist.all_reduce

    def counted_reduce(tensor, *a, **kw):
        reduces.append((tensor.device.type, dist.get_backend()))
        return all_reduce(tensor, *a, **kw)

    chaos_path = os.path.join(d, "chaos.json")
    faults = [
        {"kind": "wedge", "at_batch": 0, "structure": "regfile"},
        {"kind": "backend_error", "at_batch": 1, "structure": "regfile",
         "tier": "device"},
        {"kind": "corrupt_tally", "at_batch": 0, "structure": "fu",
         "delta": 1},
        {"kind": "torn_checkpoint", "at_ckpt": 1}]
    with open(chaos_path, "w") as f:
        json.dump({"seed": 0, "faults": faults}, f)
    port = _free_port()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    trial.taint_fast_cuda = sized
    taint_cuda.taint_fast_plain = counted_plain
    dist.all_reduce = counted_reduce
    out_a = os.path.join(d, "a")
    try:
        mesh = make_mesh()
        if (mesh.backend, mesh.world_size, mesh.size) != (
                "nccl", 1, torch.cuda.device_count()):
            fail(f"(a): make_mesh() is {mesh}, not the one-rank NCCL group")
        taint_fast_cuda.launches = 0
        t0 = time.monotonic()
        rc = cli(["run", plan_file("plan01.json", CI_TARGET,
                                   checkpoint_every=1),
                  "--outdir", out_a, "--chaos-plan", chaos_path,
                  "--dispatch-timeout", "120", "--worker", "w0"])
        torch.cuda.synchronize()
        wall_a = time.monotonic() - t0
        n_launch = taint_fast_cuda.launches
    finally:
        trial.taint_fast_cuda = launch
        taint_cuda.taint_fast_plain = plain
        dist.all_reduce = all_reduce
        dist.destroy_process_group()
    if rc != 0:
        fail(f"(a): CLI rc {rc}")
    if dist.is_initialized():
        fail("(a): the process group outlived the run")
    doc = _read_json(os.path.join(out_a, "campaign_ckpt", "campaign.json"))
    stats = _read_json(os.path.join(out_a, "stats.json"))
    batches = 0
    for s, pin in PIN_CI.items():
        st = doc["state"]["flagship"][s]
        got = dict(tallies=st["tallies"], trials=sum(st["tallies"]),
                   batches=st["next_batch"], strata=st["strata"])
        want = {k: pin[k] for k in got}
        if got != want or st["tier_trials"] != [pin["trials"], 0, 0]:
            fail(f"(a) {s}: {got}, tiers {st['tier_trials']} != JAX "
                 f"reference {want} on the device tier")
        batches += pin["batches"]
    chaos = stats["chaos"]
    kinds = {fl["kind"]: 1 for fl in faults}
    if chaos["injected"] != kinds or chaos["survived"] != kinds:
        fail(f"(a): chaos injected {chaos['injected']}, survived "
             f"{chaos['survived']}, expected {kinds} each")
    ig = stats["integrity"]
    if (ig["quarantined_batches"], ig["recovered_batches"]) != (1, 1) or \
            ig["canary_failures"] or ig["audit_mismatches"]:
        fail(f"(a): integrity counters {ig}")
    tiers = stats["resilience"]["tier_trials"]
    if tiers["cpu"] or tiers["oracle"]:
        fail(f"(a): resilience.tier_trials {tiers}")
    mon = doc["integrity"]
    want = {CI_BATCH: batches + mon["requeues"], 3: mon["canary_runs"],
            2: mon["canary_runs"], 64: mon["audit_batches"]}
    got = {n: sizes.count(n) for n in set(sizes) | set(want)}
    if got != want or n_launch != len(sizes):
        fail(f"(a): K1 launches by lane count {got} != the batches and "
             f"re-dispatches, canaries and audit samples {want} (counter "
             f"{n_launch})")
    if plain_cuda[0]:
        fail("(a): K1's plain version ran on card tensors")
    nccl = sum(1 for dev, be in reduces if dev == "cuda" and be == "nccl")
    if nccl < batches or len(reduces) != nccl:
        fail(f"(a): {nccl} all_reduce calls over NCCL on the card for "
             f"{batches} batches ({reduces[:4]})")
    args, kw, got = kept[0]
    max_err = compare(torch, got, plain(*args, **kw), "(a) first batch")
    trials_a = sum(p["trials"] for p in PIN_CI.values())
    timings["mesh_a"] = {
        "wall_s": wall_a, "trials_per_s": trials_a / wall_a,
        "batches": batches, "requeues": mon["requeues"],
        "canary_runs": mon["canary_runs"],
        "audit_batches": mon["audit_batches"], "k1_launches": n_launch,
        "nccl_all_reduces": nccl, "chaos": chaos,
        "dispatch_timeouts": stats["resilience"]["dispatch_timeouts"]}
    launches["mesh (a) NCCL world 1, chaos"] = n_launch
    log(f"(a) one-rank NCCL mesh, chaos plan: rc 0, results == PIN_CI on "
        f"the device tier, {chaos['survived']} survived, 1 batch "
        f"quarantined and recovered, K1 {n_launch} launches = {batches} "
        f"batches + {mon['requeues']} re-dispatch + 2 x "
        f"{mon['canary_runs']} canary runs + {mon['audit_batches']} audit "
        f"samples, 0 plain calls, {nccl} all_reduce over NCCL; "
        f"{wall_a:.1f} s = {trials_a / wall_a:,.0f} trials/s ({card})")
    marks("15a one-rank NCCL mesh + chaos")

    # (b) two elastic workers on the one card, worker 1 killed
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "shrewd_tpu_torch.parallel.launch",
         "--mode", "elastic", "--num-processes", "2", "--kill-worker", "1",
         "--at-batch", "2", "--plan", plan_file("plan005.json", CLI_TARGET),
         "--no-reference", "--timeout", "400"],
        capture_output=True, text=True, timeout=450)
    wall_b = time.monotonic() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        fail(f"(b): launcher rc {proc.returncode}: {proc.stdout[-1500:]} "
             f"{proc.stderr[-1500:]}")
    res = json.loads(lines[-1])
    w0, w1 = res["workers"]["w0"], res["workers"]["w1"]
    if not res["ok"] or (w1["rc"], w1.get("killed"), w1.get("dispatches")) \
            != (137, True, 2) or res["published_by"].get("w1", 0) < 1:
        fail(f"(b): the kill did not go as planned: {res}")
    if res["survivors"] != [0] or res["leases_revoked"] < 1 or \
            res["batches_reclaimed"] < 1:
        fail(f"(b): the survivor did not revoke and reclaim: {res}")
    for s, pin in PIN_CLI.items():
        got = res["results"][f"flagship/{s}"]
        if {k: got[k] for k in pin} != pin:
            fail(f"(b) {s}: survivor {got} != JAX reference {pin}")
    for name, w in (("w0", w0), ("w1", w1)):
        # two launches per canary run, as in (a)
        want = (w["batches_computed"] + w["requeues"]
                + 2 * w["canary_runs"] + w["audit_batches"])
        if w["k1_launches"] != want or w["batches_computed"] < 1:
            fail(f"(b) {name}: {w['k1_launches']} K1 launches != "
                 f"{w['batches_computed']} batches computed + "
                 f"{w['requeues']} re-dispatches + 2 x {w['canary_runs']} "
                 f"canary runs + {w['audit_batches']} audit samples")
        if w["k1_plain_card_calls"]:
            fail(f"(b) {name}: K1's plain version ran "
                 f"{w['k1_plain_card_calls']} times on card tensors")
    if w0["batches_computed"] + w1["batches_computed"] != sum(
            p["batches"] for p in PIN_CLI.values()):
        fail(f"(b): the workers computed {w0['batches_computed']} + "
             f"{w1['batches_computed']} batches, not each batch of "
             f"PIN_CLI once")
    trials_b = sum(p["trials"] for p in PIN_CLI.values())
    parts = ("k1_launches", "batches_computed", "requeues", "canary_runs",
             "audit_batches")
    timings["mesh_b"] = {
        "wall_s": wall_b, "trials_per_s": trials_b / wall_b,
        "elastic_w0": w0["elastic"], "published_by": res["published_by"],
        "k1_launches": {"w0": w0["k1_launches"], "w1": w1["k1_launches"]},
        "k1_parts": {n: {p: w[p] for p in parts}
                     for n, w in (("w0", w0), ("w1", w1))}}
    launches["mesh (b) elastic worker 0"] = w0["k1_launches"]
    launches["mesh (b) elastic worker 1 (killed)"] = w1["k1_launches"]
    log(f"(b) two elastic workers on one card: w1 rc 137 at its 2nd "
        f"dispatched batch after publishing {res['published_by']['w1']}, "
        f"w0 revoked {res['leases_revoked']} lease(s), reclaimed "
        f"{res['batches_reclaimed']} and finished == PIN_CLI; K1 launches "
        + "; ".join(
            f"{n} {w['k1_launches']} = {w['batches_computed']} batches + "
            f"{w['requeues']} re-dispatches + 2 x {w['canary_runs']} canary "
            f"runs + {w['audit_batches']} audit samples"
            for n, w in (("w0", w0), ("w1", w1)))
        + f", 0 plain calls; {wall_b:.1f} s "
        f"= {trials_b / wall_b:,.0f} trials/s, both workers on the one card "
        f"(not a scaling number; {card})")
    shutil.rmtree(d, ignore_errors=True)
    timings["mesh_phase_s"] = time.monotonic() - t_phase
    marks("15b elastic workers")
    return {"timings": timings, "launches": launches, "k1_max_err": max_err}


def noc_table_outcome(msgs, ftype: int, router: int, cycle: int) -> int:
    """The host oracle of a table-classified NoC lane: the first message on
    ``router`` at ``cycle`` decides by the (type, kind) table; none is
    masked."""
    from shrewd_tpu_torch.models.noc import _HIT_OUTCOME

    for m in range(len(msgs.kind)):
        h = cycle - int(msgs.depart[m])
        if 0 <= h < int(msgs.hops[m]) and int(msgs.route[m, h]) == router:
            return int(_HIT_OUTCOME[ftype, int(msgs.kind[m])])
    return 0


def noc_pipe_outcome(msgs, deliver, corrupt) -> int:
    """The outcome of a pipeline lane from the oracle's (deliver,
    corrupt): undelivered or a corrupt delivered request is DUE, a corrupt
    delivered payload SDC."""
    from shrewd_tpu_torch.models.noc import MSG_REQ
    from shrewd_tpu_torch.ops import classify as C

    req = np.asarray(msgs.kind) == MSG_REQ
    ok = np.asarray(deliver) >= 0
    corrupt = np.asarray(corrupt)
    if (~ok).any() or (corrupt & req & ok).any():
        return C.OUTCOME_DUE
    if (corrupt & ~req & ok).any():
        return C.OUTCOME_SDC
    return C.OUTCOME_MASKED


def tier_phase(torch, marks, card) -> dict:
    """Phase 14, the tier structures → their timings.  The scalar
    pipeline oracle runs in a pool of worker processes, shut down with the
    phase."""
    import concurrent.futures as cf
    import multiprocessing
    import os

    # the phase's CPU kernels run on one thread: with the pool busy on
    # every core, a full intra-op pool of spinning threads slows them
    # tenfold and more
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with cf.ProcessPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1),
                mp_context=multiprocessing.get_context("spawn")) as pool:
            return _tier_phase(torch, marks, card, pool)
    finally:
        torch.set_num_threads(threads)


def _tier_phase(torch, marks, card, pool) -> dict:
    import os
    import shutil
    import tempfile

    from shrewd_tpu_torch import native
    from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
    from shrewd_tpu_torch.campaign.plan import CampaignPlan, TraceFileSpec
    from shrewd_tpu_torch.main import main as cli
    from shrewd_tpu_torch.models import mesi as M
    from shrewd_tpu_torch.models import noc as N
    from shrewd_tpu_torch.models import ruby as R
    from shrewd_tpu_torch.ops import classify as C
    from shrewd_tpu_torch.ops import taint_cuda
    from shrewd_tpu_torch.ops.taint_cuda import taint_fast_cuda
    from shrewd_tpu_torch.trace import format as tf
    from shrewd_tpu_torch.utils import prng

    dev = torch.device("cuda")
    timings: dict = {"card": card}
    t_phase = time.monotonic()

    def timed(fn):
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        return out, time.monotonic() - t0

    # (a) builds: the cache tier on the flagship window, the coherence
    # tiers at the plan's defaults
    trace = native.generate_trace(**FLAGSHIP)
    stream, t_stream = timed(lambda: R.golden_access_stream(trace))
    l1_cfg, l2_cfg = R.CacheConfig(), R.CacheConfig(n_sets=256, n_ways=8)
    (tl1, miss1), t_tl1 = timed(lambda: R.simulate_cache(stream, l1_cfg,
                                                         trace.n))
    (tl2, _), t_tl2 = timed(lambda: R.simulate_cache(miss1, l2_cfg,
                                                     trace.n))
    cache, t_k1 = timed(lambda: R.CacheKernel(tl1, l1_cfg, device=dev))
    cache2, t_k2 = timed(lambda: R.CacheKernel(tl2, l2_cfg, device=dev))
    mcfg, ncfg = M.MesiConfig(), N.NocConfig()
    tstream, t_ts = timed(lambda: M.torture_stream(
        mcfg, COHERENCE_ACCESSES, COHERENCE_MEM_WORDS, seed=0))
    init = np.random.default_rng(0).integers(
        0, 1 << 32, COHERENCE_MEM_WORDS, dtype=np.uint64).astype(np.uint32)
    mesi, t_mesi = timed(lambda: M.MesiKernel(tstream, mcfg, init,
                                              device=dev))
    msgs, t_msgs = timed(lambda: N.build_message_trace(tstream, mcfg, ncfg))
    noc, t_noc = timed(lambda: N.NocKernel(msgs, ncfg, device=dev))
    timings["builds_s"] = {
        "access_stream": t_stream, "l1_timeline": t_tl1,
        "l2_timeline": t_tl2, "l1_kernel": t_k1, "l2_kernel": t_k2,
        "torture_stream": t_ts, "mesi_golden_walk": t_mesi,
        "message_trace": t_msgs, "noc_kernel_and_horizon": t_noc}
    log(f"tier builds (s): {json.dumps(timings['builds_s'])}; "
        f"{len(stream.cycle)} accesses, {len(tl1.wkey)} word and "
        f"{len(tl1.lkey)} line events (L1), {len(tl2.wkey)} and "
        f"{len(tl2.lkey)} (L2); {len(msgs.kind)} messages of up to "
        f"{msgs.route.shape[1]} hops, NoC horizon {noc._horizon} cycles")
    # the pipeline lanes' oracle runs in the pool while the card works:
    # 16 lanes of each pipeline type, coordinates drawn with numpy
    rng = np.random.default_rng(14)
    n_pipe = N_TIER_ORACLE
    co = [rng.integers(0, ncfg.n_routers, n_pipe),
          rng.integers(0, noc.n_cycles, n_pipe),
          np.repeat(N.PIPELINE_TYPES, n_pipe // len(N.PIPELINE_TYPES)),
          rng.integers(0, N.N_VC, n_pipe)]
    pipe_jobs = [pool.submit(N.scalar_flit_sim, msgs, ncfg,
                             fault=tuple(int(x[b]) for x in co),
                             horizon=noc._horizon) for b in range(n_pipe)]
    marks("14a tier builds")

    # (b) every structure on the card
    keys = prng.trial_keys(prng.campaign_key(0), N_TIER_CACHE)
    cpu_keys = keys[:N_TIER_CPU].cpu()

    def gate(kern, kcpu, s, n, n_pin, pin, what, reps=1):
        """One structure's gates on the card: the per-key outcomes of ``n``
        keys, their first ``n_pin`` against the JAX pin and their first
        N_TIER_CPU against the CPU kernel's; then ``run_keys`` (the tally
        path the campaign takes) timed, its tally the outcomes' count →
        (outcomes on the host, tally, ms of the gated call, ms timed)."""
        (out, t_gate) = timed(lambda: kern.outcomes_from_keys(
            keys[:n], s).cpu().numpy())
        tally = np.bincount(out, minlength=C.N_OUTCOMES).tolist()
        got = np.bincount(out[:n_pin], minlength=C.N_OUTCOMES).tolist()
        if got != pin:
            fail(f"{what}: first {n_pin} keys {got} != JAX reference {pin}")
        want = kcpu.outcomes_from_keys(cpu_keys, s).numpy()
        if not np.array_equal(out[:N_TIER_CPU], want):
            fail(f"{what}: card outcomes differ from the CPU's on "
                 f"{int((out[:N_TIER_CPU] != want).sum())} of {N_TIER_CPU} "
                 "keys")
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            got = kern.run_keys(keys[:n], s).tolist()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            if got != tally:
                fail(f"{what}: run_keys's tally {got} differs from the "
                     f"outcomes' {tally}")
        return out, tally, t_gate * 1e3, statistics.median(times)

    for lvl, kern, tl, cfg in (("l1", cache, tl1, l1_cfg),
                               ("l2", cache2, tl2, l2_cfg)):
        kcpu = R.CacheKernel(tl, cfg, device="cpu")
        for s in R.CACHE_STRUCTURES:
            what = f"cache {lvl} {s}"
            _, tally, _, ms = gate(kern, kcpu, s, N_TIER_CACHE, N_PIN_CACHE,
                                   PIN_CACHE[lvl][s], what, reps=3)
            timings[f"cache_{lvl}_{s}_ms"] = ms
            log(f"{what}: {N_TIER_CACHE} keys {tally}, pin, card == CPU; "
                f"{ms:.3f} ms ({N_TIER_CACHE / ms * 1e3:,.0f} trials/s)")
    mesi_cpu = M.MesiKernel(tstream, mcfg, init, device="cpu")
    gl, gm = M.scalar_mesi(tstream, mcfg, init)
    set_bits = int(np.log2(mcfg.n_sets))

    def mesi_oracle(kern, tr, cfg, mem, golden, faults, what,
                    out=None) -> int:
        """The walk's outcomes (``out``, or the kernel's on ``faults``)
        against scalar_mesi's on the lanes of ``faults``; → lanes apart in
        reference fault R6's class (a TBE flip of a set-index bit on a
        load), any other difference fails."""
        if out is None:
            out = kern.outcomes_of_faults(faults).cpu().numpy()
        r6 = 0
        for b in range(len(faults.cycle)):
            f = tuple(int(x[b]) for x in faults)
            sl, sm = M.scalar_mesi(tr, cfg, mem, fault=f)
            sdc = not (np.array_equal(sl, golden[0])
                       and np.array_equal(sm, golden[1]))
            want = C.OUTCOME_SDC if sdc else C.OUTCOME_MASKED
            if out[b] == want:
                continue
            if (f[0] == M.TGT_TBE and f[4] < set_bits
                    and not tr.is_store[f[5]]):
                r6 += 1
                continue
            fail(f"{what}: lane {b} fault {f}: walk {out[b]}, scalar "
                 f"oracle {want}")
        return r6

    tkeys = keys[:N_TIER]
    for s in ("state", "tag", "dir", "tbe"):
        what = f"mesi {s}"
        out, tally, t_gate, ms = gate(mesi, mesi_cpu, s, N_TIER, N_PIN_MESI,
                                      PIN_MESI[s], what)
        r6 = mesi_oracle(mesi, tstream, mcfg, init, (gl, gm),
                         mesi.sample_batch(tkeys[:N_TIER_ORACLE], s), what,
                         out)
        timings[f"mesi_{s}_ms"] = ms
        timings[f"mesi_{s}_ms_per_step"] = ms / COHERENCE_ACCESSES
        log(f"{what}: {N_TIER} keys {tally}, pin, {N_TIER_ORACLE} lanes "
            f"== scalar_mesi ({r6} apart in R6's class), card == CPU; "
            f"{ms:.1f} ms = {ms / COHERENCE_ACCESSES * 1e3:.1f} µs per "
            f"step over {COHERENCE_ACCESSES} steps (gated call "
            f"{t_gate:.1f} ms)")
    noc_cpu = N.NocKernel(msgs, ncfg, device="cpu")
    syncs0, lanes0, steps0 = noc.host_syncs, noc.pipeline_lanes, \
        noc.pipeline_steps
    _, tally, t_gate, ms = gate(noc, noc_cpu, "router", N_TIER, N_PIN_NOC,
                                PIN_NOC, "noc router")
    # the gated call and the timed call
    call = {"host_syncs": (noc.host_syncs - syncs0) / 2,
            "pipeline_lanes": (noc.pipeline_lanes - lanes0) / 2,
            "pipeline_steps": (noc.pipeline_steps - steps0) / 2}
    # the pipeline on the 64 constructed lanes: its deliver/corrupt, then
    # the lanes' outcomes timed (all of them run the pipeline)
    faults = N.NocFault(*(torch.as_tensor(x, device=dev) for x in co))
    d_card, c_card = N.flit_sim(msgs, ncfg, faults, noc._horizon)
    syncs0, steps0 = noc.host_syncs, noc.pipeline_steps
    out, t_pipe = timed(lambda: noc.outcomes_of_faults(faults).cpu().numpy())
    steps, syncs = noc.pipeline_steps - steps0, noc.host_syncs - syncs0
    for b, job in enumerate(pipe_jobs):
        sd, sc = job.result()
        if not (np.array_equal(d_card[b].cpu().numpy(), sd)
                and np.array_equal(c_card[b].cpu().numpy(), sc)):
            fail(f"noc pipeline lane {b} {[int(x[b]) for x in co]}: the "
                 "card's deliver/corrupt differ from scalar_flit_sim")
        if out[b] != noc_pipe_outcome(msgs, sd, sc):
            fail(f"noc pipeline lane {b}: outcome {out[b]} != the oracle's")
    timings.update(noc_router_ms=ms, noc_call=call,
                   pipeline_ms=t_pipe * 1e3, pipeline_steps=steps,
                   pipeline_syncs=syncs,
                   pipeline_ms_per_step=t_pipe * 1e3 / max(steps, 1))
    log(f"noc router: {N_TIER} keys {tally}, pin, card == CPU; {ms:.1f} ms "
        f"(a call: {json.dumps(call)}); the pipeline on {n_pipe} lanes of "
        f"the four pipeline types == scalar_flit_sim and its outcomes, "
        f"{int((d_card < 0).any(dim=1).sum())} lanes undelivered: "
        f"{t_pipe * 1e3:.1f} ms over {steps} of {noc._horizon} cycles = "
        f"{t_pipe * 1e6 / max(steps, 1):.1f} µs per step, {syncs} host syncs")
    # where a batch step's time goes (tally_on_device, stratified, as the
    # orchestrator calls it): CUDA events around the draws, the outcomes
    # (the cache's searchsorted and gathers, the MESI walk, the NoC table
    # and pipeline) and the strata and tally; then the 2-key seed-canary
    # call every campaign batch adds
    from shrewd_tpu_torch.ops.trial import N_STRATA

    def parts(kern, s, n, reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        rows = []
        for _ in range(reps):
            ev[0].record()
            f = kern.sample_batch(keys[:n], s)
            ev[1].record()
            o = kern.outcomes_of_faults(f, s)
            ev[2].record()
            C.tally_stratified(o, kern.strata_of(f), N_STRATA)
            ev[3].record()
            ev[3].synchronize()
            rows.append([ev[j].elapsed_time(ev[j + 1]) for j in range(3)])
        ev[0].record()
        kern.outcomes_from_keys(keys[:2], s)
        ev[1].record()
        ev[1].synchronize()
        med = [statistics.median(r[j] for r in rows) for j in range(3)]
        return {"keys": n, "draws_ms": med[0], "outcomes_ms": med[1],
                "strata_tally_ms": med[2],
                "canary_2_keys_ms": ev[0].elapsed_time(ev[1])}

    split = {"cache_l1_data": parts(cache, "data", N_TIER_CACHE, 3),
             "cache_l1_state": parts(cache, "state", N_TIER_CACHE, 3),
             "mesi_state": parts(mesi, "state", CI_BATCH, 1),
             "noc_router": parts(noc, "router", CI_BATCH, 1)}
    timings["batch_parts"] = split
    for name, p in split.items():
        log(f"{name} batch step, {p['keys']} keys: draws "
            f"{p['draws_ms']:.3f} ms, outcomes {p['outcomes_ms']:.3f} ms, "
            f"strata and tally {p['strata_tally_ms']:.3f} ms; the 2-key "
            f"seed canary {p['canary_2_keys_ms']:.3f} ms ({card})")
    marks("14b tier structures")

    # (c) scaling: 16 cores on the 4x4 mesh of gem5's Garnet Mesh_XY
    m16, n16 = M.MesiConfig(n_cores=16), N.NocConfig(mesh_x=4, mesh_y=4)
    ts16 = M.torture_stream(m16, COHERENCE_ACCESSES, COHERENCE_MEM_WORDS,
                            seed=0)
    mesi16, t_m16 = timed(lambda: M.MesiKernel(ts16, m16, init, device=dev))
    msgs16 = N.build_message_trace(ts16, m16, n16)
    noc16, t_n16 = timed(lambda: N.NocKernel(msgs16, n16, device=dev))
    g16 = M.scalar_mesi(ts16, m16, init)
    scale = {"mesi_build_s": t_m16, "noc_build_s": t_n16,
             "messages": len(msgs16.kind), "horizon": noc16._horizon}
    per = N_SCALE_ORACLE // 4
    for s in ("state", "tag"):
        tally, t = timed(lambda: mesi16.run_keys(tkeys, s).tolist())
        if sum(tally) != N_TIER:
            fail(f"16-core mesi {s}: tally {tally}")
        mesi_oracle(mesi16, ts16, m16, init, g16,
                    mesi16.sample_batch(tkeys[:per], s), f"16-core {s}")
        scale[f"mesi_{s}_ms"] = t * 1e3
        scale[f"mesi_{s}_tally"] = tally
    tally, t = timed(lambda: noc16.run_keys(tkeys).tolist())
    if sum(tally) != N_TIER:
        fail(f"16-core noc: tally {tally}")
    f16 = noc16.sample_batch(tkeys[:2 * per])
    out = noc16.outcomes_of_faults(f16).cpu().numpy()
    for b in range(2 * per):
        r, cyc, ft, vc = (int(x[b]) for x in f16)
        if ft in N.PIPELINE_TYPES:
            want = noc_pipe_outcome(msgs16, *N.scalar_flit_sim(
                msgs16, n16, fault=(r, cyc, ft, vc),
                horizon=noc16._horizon))
        else:
            want = noc_table_outcome(msgs16, ft, r, cyc)
        if out[b] != want:
            fail(f"16-core noc lane {b} ({r}, {cyc}, {ft}, {vc}): "
                 f"{out[b]} != the oracle's {want}")
    scale.update(noc_ms=t * 1e3, noc_tally=tally)
    timings["scale_16_cores"] = scale
    log(f"16 cores on a 4x4 mesh ({scale['messages']} messages, horizon "
        f"{scale['horizon']}): {json.dumps(scale)}; {N_SCALE_ORACLE} "
        f"outcomes == the scalar oracles")
    marks("14c scaling")

    # (d) the campaign CLI over the six tier structures
    d = tempfile.mkdtemp(prefix="chip_smoke_tiers_")
    npz = os.path.join(d, "flagship.npz")
    tf.save(npz, trace, meta={"source": "native.generate_trace",
                              **FLAGSHIP})
    structures = [s for _, s in PIN_TIER_CLI]

    def plan_file(name, **kw):
        plan = CampaignPlan(
            simpoints=[TraceFileSpec(name="flagship", path=npz)],
            structures=structures, batch_size=CI_BATCH,
            target_halfwidth=CI_TARGET, stratify=True,
            coherence_accesses=TIER_CLI_ACCESSES, **kw)
        path = os.path.join(d, name)
        plan.dump_json(path)
        return path

    plain_cuda = [0]
    plain = taint_cuda.taint_fast_plain

    def counted_plain(*a, **kw):
        if a[3].kind.device.type == "cuda":
            plain_cuda[0] += 1
        return plain(*a, **kw)

    taint_cuda.taint_fast_plain = counted_plain
    taint_fast_cuda.launches = 0

    def check(tag, out, n0=0):
        doc = _read_json(os.path.join(out, "campaign_ckpt",
                                      "campaign.json"))
        stats = _read_json(os.path.join(out, "stats.json"))
        batches = 0
        for (spn, s), pin in PIN_TIER_CLI.items():
            st = doc["state"][spn][s]
            got = dict(tallies=st["tallies"], trials=sum(st["tallies"]),
                       batches=st["next_batch"], strata=st["strata"])
            if got != pin or not st["converged"]:
                fail(f"{tag} {spn}/{s}: {got} (converged "
                     f"{st['converged']}) != JAX reference {pin}")
            if st["tier_trials"] != [pin["trials"], 0, 0]:
                fail(f"{tag} {s}: tier trials {st['tier_trials']}")
            batches += pin["batches"]
        ig = stats["integrity"]
        bad = {k: ig[k] for k in ("canary_failures", "invariant_violations",
                                  "audit_mismatches", "quarantined_batches")
               if ig[k]}
        tiers = stats["resilience"]["tier_trials"]
        if bad or tiers["cpu"] or tiers["oracle"]:
            fail(f"{tag}: integrity {bad}, tiers {tiers}")
        # a seed-canary run of 2 trials per batch (per interval for
        # until-CI), every one passed
        runs = doc["integrity"]["canary_runs"]
        if runs < 1 or ig["canary_trials"] != 2 * runs:
            fail(f"{tag}: {runs} seed-canary runs, {ig['canary_trials']} "
                 "canary trials")
        return batches - n0, runs

    def run(tag, argv, n0=0):
        t0 = time.monotonic()
        rc = cli(argv)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        if rc != 0:
            fail(f"{tag}: CLI rc {rc}")
        n, runs = check(tag, argv[argv.index("--outdir") + 1], n0)
        timings[f"tier_cli_{tag}"] = {"wall_s": wall, "batches": n,
                                      "canary_runs": runs,
                                      "trials_per_s": n * CI_BATCH / wall}
        log(f"tier CLI {tag}: rc 0, every result == JAX pins, every batch "
            f"on the device tier, integrity clean, {runs} seed-canary runs "
            f"passed; {n} batches in {wall:.1f} s = "
            f"{n * CI_BATCH / wall:,.0f} trials/s ({card})")

    plan = plan_file("tiers.json")
    run("serial", ["run", plan, "--outdir", os.path.join(d, "s")])
    run("until-ci", ["run", plan, "--outdir", os.path.join(d, "u"),
                     "--until-ci"])
    # drained after its first coherence batch, then finished by resume
    orch = Orchestrator(CampaignPlan.from_dict(_read_json(
        plan_file("drain.json", checkpoint_every=1))),
        outdir=os.path.join(d, "r"))
    seen = before = 0
    for ev, p in orch.events():
        if ev.name == "BATCH_COMPLETE":
            before += 1
            if p.simpoint == "coherence":
                seen += 1
                orch.request_drain()
        if ev.name == "PREEMPTED":
            break
    if not orch.preempted or seen != 1:
        fail(f"tier CLI drain: stopped {orch.preempted}, {seen} coherence "
             "batches")
    run("resume", ["resume", os.path.join(d, "r", "campaign_ckpt"),
                   "--outdir", os.path.join(d, "r2")], n0=before)
    taint_cuda.taint_fast_plain = plain
    if plain_cuda[0] or taint_fast_cuda.launches:
        fail(f"tier CLI: K1 launched {taint_fast_cuda.launches} times and "
             f"its plain version ran {plain_cuda[0]} times on card tensors")
    shutil.rmtree(d, ignore_errors=True)
    timings["tier_phase_s"] = time.monotonic() - t_phase
    log(f"tier CLI: no K1 launch and no call of K1's plain version; phase "
        f"14 {timings['tier_phase_s']:.1f} s ({card})")
    marks("14d tier CLI")
    return timings


def ingest_phase(torch, marks, card) -> dict:
    """Phase 16, real workload binaries on the card → the timings, K1's
    and K2's launches on the ingested windows' paths and their largest
    differences from their plain versions there.  (a) ingest
    ``workloads/intmm.c``; (b) the campaign CLI on its windows; (c) the
    store-opened chunked route; (d) ``hostdiff`` on ``workloads/sort.c``.
    Every gate holds the card against the port on the CPU, the C++ oracle
    or the kernels' plain versions, never against a tally pinned
    elsewhere: the workloads are built with this machine's gcc."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    from shrewd_tpu_torch.campaign.plan import CampaignPlan
    from shrewd_tpu_torch.ingest import hostdiff as hd
    from shrewd_tpu_torch.ingest.lift import read_nativetrace, static_decode
    from shrewd_tpu_torch.ingest.pipeline import (DEFAULT_AXES, STAGES,
                                                  IngestPipeline,
                                                  IngestQuarantine)
    from shrewd_tpu_torch.ingest.store import ArtifactStore
    from shrewd_tpu_torch.main import main as cli
    from shrewd_tpu_torch.models.o3 import O3Config
    from shrewd_tpu_torch.obs import clock
    from shrewd_tpu_torch.obs import trace as obs_trace
    from shrewd_tpu_torch.ops import chunked, taint_cuda, trial
    from shrewd_tpu_torch.ops import window as W
    from shrewd_tpu_torch.ops.chunked import ChunkedCampaign
    from shrewd_tpu_torch.ops.taint import taint_chunk
    from shrewd_tpu_torch.ops.taint_cuda import (taint_chunk_cuda,
                                                 taint_fast_cuda)
    from shrewd_tpu_torch.ops.trial import TrialKernel
    from shrewd_tpu_torch.service.journal import FleetJournal
    from shrewd_tpu_torch.trace import format as tf
    from shrewd_tpu_torch.utils import prng

    t_phase = time.monotonic()
    timings: dict = {"card": card}
    launches: dict = {}
    d = tempfile.mkdtemp(prefix="chip_smoke_ingest_")

    # ptrace first: the capture (nativetrace), the host SFI (hostsfi), and
    # objdump / nm behind static_decode and elf_markers
    t0 = time.monotonic()
    paths = hd.build_tools("workloads/intmm.c")
    sort_paths = hd.build_tools("workloads/sort.c")
    lzss = hd.build_tools("workloads/lzss.c")
    probe = os.path.join(d, "probe.bin")
    proc = subprocess.run(
        [str(paths.tracer), probe, f"{paths.begin:x}", f"{paths.end:x}",
         "64", str(paths.workload)], capture_output=True, text=True)
    if proc.returncode not in (0, 1) or not os.path.exists(probe):
        fail(f"ptrace capture does not run here: rc {proc.returncode} "
             f"{proc.stderr.strip()[-200:]}")
    if len(read_nativetrace(probe).steps) < 2 or not static_decode(
            str(paths.workload)):
        fail("ptrace capture or objdump decode came back empty")
    host = hd.run_host(sort_paths, np.array([[0, 0, 0]], np.int64))
    log(f"ptrace, objdump and nm work: workloads built, a 64-step capture, "
        f"one hostsfi trial (class {int(host[0])}) "
        f"({time.monotonic() - t0:.1f} s)")

    # (a) ingest intmm.c at DEFAULT_AXES with the preprocess stage
    store = ArtifactStore(os.path.join(d, "store"))
    digest = store.put_binary(open(paths.workload, "rb").read())
    axes = {**DEFAULT_AXES, "preprocess": True, "chunk": INGEST_CHUNK}

    def kinds(outdir):
        return [(r["kind"], r.get("stage"), r.get("cached")) for r in
                FleetJournal.replay_path(os.path.join(
                    outdir, "ingest.jsonl"))[0]]

    # each stage's seconds: from the tracer's ingest_stage events, each
    # timed from the event before it (the first from the run's start)
    cold = IngestPipeline(os.path.join(d, "t0"), store, digest, axes=axes)
    tracer = obs_trace.enable()
    t0 = clock.monotonic()
    plan = cold.run()
    t_cold = clock.monotonic() - t0
    obs_trace.disable()
    stage_s: dict = {}
    t = t0
    for ev in tracer.snapshot():
        if ev["name"] == "ingest_stage":
            stage_s[ev["args"]["stage"]] = ev["ts"] - t
            t = ev["ts"]
    want = [("ingest_stage", s, False) for s in STAGES + ("preprocess",)]
    if kinds(cold.outdir) != want + [("ingest_done", None, None)]:
        fail(f"(a) journal {kinds(cold.outdir)}")
    if len(plan["simpoints"]) != 3:
        fail(f"(a) {len(plan['simpoints'])} windows, not 3")
    pre = store.get_doc(digest, cold.key, "preprocess")
    if any(w["C"] < 2 for w in pre["windows"]):
        fail(f"(a) a window spans one chunk: {pre['windows']}")
    t0 = time.monotonic()
    warm = IngestPipeline(os.path.join(d, "t1"), store, digest, axes=axes)
    if warm.run() != plan or (warm.captures, warm.lifts) != (0, 0):
        fail(f"(a) warm start: {warm.captures} captures, {warm.lifts} "
             "lifts")
    t_warm = time.monotonic() - t0
    lz_store = ArtifactStore(os.path.join(d, "lz_store"))
    lz_digest = lz_store.put_binary(open(lzss.workload, "rb").read())
    lz_out = os.path.join(d, "lz")
    t0 = time.monotonic()
    try:
        IngestPipeline(lz_out, lz_store, lz_digest, axes=DEFAULT_AXES).run()
        fail("(a) lzss.c at DEFAULT_AXES was not quarantined")
    except IngestQuarantine as q:
        if q.stage != "capture":
            fail(f"(a) lzss.c quarantined at {q.stage}, not capture")
        lz_reason = str(q)
    if kinds(lz_out)[-1][:2] != ("ingest_quarantine", "capture"):
        fail(f"(a) lzss.c journal {kinds(lz_out)}")
    t_lz = time.monotonic() - t0
    traces = [tf.load(store.payload_path(digest, cold.key, e["file"]))[0]
              for e in plan["simpoints"]]
    timings["ingest"] = {
        "cold_s": t_cold, "stage_s": stage_s, "warm_s": t_warm,
        "lzss_quarantine_s": t_lz,
        "windows": [{"name": e["name"], "uops": int(t.n), "C": w["C"]}
                    for e, t, w in zip(plan["simpoints"], traces,
                                       pre["windows"])],
        "nphys": int(traces[0].nphys), "mem_words": int(traces[0].mem_words)}
    log(f"(a) intmm.c ingested in {t_cold:.1f} s, stages "
        + ", ".join(f"{s} {v:.2f} s" for s, v in stage_s.items())
        + f": {len(traces)} windows of "
        f"{[int(t.n) for t in traces]} µops, nphys {traces[0].nphys}, "
        f"{traces[0].mem_words} words, {[w['C'] for w in pre['windows']]} "
        f"chunks of {INGEST_CHUNK}; warm start {t_warm:.3f} s with 0 "
        f"captures and 0 lifts; lzss.c quarantined at capture "
        f"({lz_reason[-80:]!r}) in {t_lz:.1f} s, journaled")
    marks("16 (a) ingest")

    # (b) the campaign CLI on the ingested windows
    sizes: list = []
    kept: dict = {}
    plain_cuda = [0]
    launch, plain = trial.taint_fast_cuda, taint_cuda.taint_fast_plain

    def sized(*a, **kw):
        got = launch(*a, **kw)
        n = int(a[3].kind.shape[0])
        sizes.append(n)
        if n == CI_BATCH and id(a[0]) not in kept:
            kept[id(a[0])] = (a, {x: v for x, v in kw.items()
                                  if x != "stream"}, got)
        return got

    def counted_plain(*a, **kw):
        if a[3].kind.device.type == "cuda":
            plain_cuda[0] += 1
        return plain(*a, **kw)

    trial.taint_fast_cuda = sized
    taint_cuda.taint_fast_plain = counted_plain
    plan_path = os.path.join(d, "resolved.json")
    CampaignPlan.from_dict(cold.resolved_plan({
        "structures": ["regfile", "fu"], "batch_size": CI_BATCH,
        "target_halfwidth": CI_TARGET, "stratify": True})).dump_json(
            plan_path)
    out = os.path.join(d, "campaign")
    taint_fast_cuda.launches = 0
    t0 = time.monotonic()
    rc = cli(["run", plan_path, "--outdir", out])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    trial.taint_fast_cuda = launch
    taint_cuda.taint_fast_plain = plain
    if rc != 0:
        fail(f"(b) CLI rc {rc}")
    doc = _read_json(os.path.join(out, "campaign_ckpt", "campaign.json"))
    stats = _read_json(os.path.join(out, "stats.json"))
    batches = trials = 0
    for name, per in doc["state"].items():
        for s, st in per.items():
            batches += st["next_batch"]
            trials += sum(st["tallies"])
            if st["tier_trials"][1:] != [0, 0]:
                fail(f"(b) {name} {s}: tier trials {st['tier_trials']}")
    tiers = stats["resilience"]["tier_trials"]
    if tiers["cpu"] or tiers["oracle"]:
        fail(f"(b) resilience.tier_trials {tiers}")
    mon = doc["integrity"]
    want_k1 = batches + 2 * mon["canary_runs"] + mon["audit_batches"]
    n_batch = sizes.count(CI_BATCH)
    if (taint_fast_cuda.launches != len(sizes) or len(sizes) != want_k1
            or n_batch != batches):
        fail(f"(b) K1 launches {taint_fast_cuda.launches} ({n_batch} of "
             f"{CI_BATCH} lanes) != {batches} batches + 2 x "
             f"{mon['canary_runs']} canary runs + {mon['audit_batches']} "
             "audit samples")
    if plain_cuda[0]:
        fail("(b) K1's plain version ran on card tensors")
    if len(kept) != len(traces):
        fail(f"(b) first batch launches kept for {len(kept)} of "
             f"{len(traces)} windows")
    max_err = 0
    for i, (args, kw, got) in enumerate(kept.values()):
        max_err = max(max_err, compare(torch, got, plain(*args, **kw),
                                       f"(b) window {i} first batch"))
    launches["ingested windows campaign CLI (b)"] = len(sizes)
    n_oracle = 0
    for t in traces:
        kernel = TrialKernel(t, O3Config(), device="cuda")
        faults = kernel.sample_batch(prng.trial_keys(
            prng.campaign_key(0), N_ORACLE), "regfile")
        bad = int((kernel.run_batch_hybrid(faults, may_latch=False)
                   != kernel.oracle_outcomes(faults)).sum())
        if bad:
            fail(f"(b) {bad}/{N_ORACLE} outcomes of a window differ from "
                 "the C++ oracle")
        n_oracle += N_ORACLE
    timings["ingest_campaign"] = {
        "rc": 0, "batches": batches, "trials": trials, "wall_s": wall,
        "trials_per_s": trials / wall, "k1_launches": len(sizes),
        "canary_runs": mon["canary_runs"],
        "audit_batches": mon["audit_batches"]}
    log(f"(b) CLI on the ingested windows (regfile, fu; batch {CI_BATCH}, "
        f"stratified, target {CI_TARGET}): rc 0, {batches} batches, "
        f"{trials} trials, every batch on the device tier, K1 "
        f"{len(sizes)} launches = {batches} batches + 2 x "
        f"{mon['canary_runs']} canary runs + {mon['audit_batches']} audit "
        f"samples, 0 plain calls, K1 == plain on each window's first "
        f"batch; {n_oracle} outcomes == C++ oracle; {wall:.1f} s = "
        f"{trials / wall:,.0f} trials/s ({card})")
    marks("16 (b) campaign on the ingested windows")

    # (c) the store-opened chunked route
    real_k2 = chunked.taint_chunk_cuda
    k2_err = [0]

    def held(*a, **kw):
        got = real_k2(*a, **kw)
        ref = taint_chunk(*a, **{x: v for x, v in kw.items()
                                 if x != "stream"})
        for x, y in zip(got, ref):
            diff = (x.to(torch.int64) - y.to(torch.int64)).abs()
            k2_err[0] = max(k2_err[0], int(diff.max()) if diff.numel()
                            else 0)
            if not torch.equal(x.to(torch.int64), y.to(torch.int64)):
                fail("(c) K2 and its plain version differ on a wave")
        return got

    chunked.taint_chunk_cuda = held
    W.clear_registry()
    builds, hits = W.STATS["builds"], W.STATS["store_hits"]
    n_k2 = fast_waves = 0
    t0 = time.monotonic()
    for t in traces:
        kernel = TrialKernel(t, O3Config(), device="cuda")
        camp = ChunkedCampaign(kernel, chunk=INGEST_CHUNK, store=store)
        exact_waves = [0]
        trial_chunk = camp._trial_chunk

        def counted(*a, tc=trial_chunk, ew=exact_waves):
            ew[0] += 1
            return tc(*a)
        camp._trial_chunk = counted
        keys = prng.trial_keys(prng.campaign_key(5), N_CHUNK_KEYS)
        taint_chunk_cuda.launches = 0
        got = camp.outcomes_from_keys(keys, "regfile")
        n = taint_chunk_cuda.launches
        waves = camp.last_stats["waves"] - exact_waves[0]
        if n != waves or n < 1:
            fail(f"(c) {n} K2 launches for {waves} fast waves")
        n_k2 += n
        fast_waves += waves
        exact = ChunkedCampaign(kernel, chunk=INGEST_CHUNK, engine="exact")
        if not np.array_equal(got, exact.outcomes_from_keys(keys,
                                                            "regfile")):
            fail("(c) store-opened taint engine != the exact engine")
    chunked.taint_chunk_cuda = real_k2
    if W.STATS["store_hits"] - hits < 1 or W.STATS["builds"] != builds:
        fail(f"(c) store hits {W.STATS['store_hits'] - hits}, builds "
             f"{W.STATS['builds'] - builds}: a window was preprocessed "
             "again")
    launches["store-opened chunked (c)"] = n_k2
    timings["ingest_chunked"] = {
        "s": time.monotonic() - t0, "k2_launches": n_k2,
        "fast_waves": fast_waves,
        "store_hits": W.STATS["store_hits"] - hits}
    log(f"(c) ChunkedCampaign(chunk={INGEST_CHUNK}, store=…) on each "
        f"window: opened from the store ({W.STATS['store_hits'] - hits} "
        f"hits, 0 builds), {n_k2} K2 launches = {fast_waves} fast waves, "
        f"each == plain; {N_CHUNK_KEYS} outcomes per window == the exact "
        f"engine ({time.monotonic() - t0:.1f} s)")
    marks("16 (c) store-opened chunked route")

    # (d) hostdiff on sort.c: the CLI in output and device64 modes, each
    # report read back and its emulator escalations held to account.  One
    # ptrace capture at a time: on an H100 host, captures run alongside
    # one another came back truncated or with the workload dead in
    # glibc's start-up
    lines, escal, cli_s = {}, {}, {}
    for mode, n_trials in HOSTDIFF_TRIALS.items():
        rep_path = os.path.join(d, f"hostdiff_{mode}.json")
        buf = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            rc = cli(["hostdiff", "--workload", "workloads/sort.c",
                      "--mode", mode, "--trials", str(n_trials),
                      "--seed", "0", "--out", rep_path])
        cli_s[mode] = time.monotonic() - t0
        if rc != 0:
            fail(f"(d) hostdiff --mode {mode} rc {rc}")
        lines[mode] = json.loads(buf.getvalue().strip().splitlines()[-1])
        rep = _read_json(rep_path)
        escal[mode] = escalations(rep, f"(d) hostdiff --mode {mode}")
        log(f"(d) hostdiff --mode {mode} --trials {n_trials}: rc 0 in "
            f"{cli_s[mode]:.1f} s, {rep['lift_stats']['uops']} µops lifted, "
            f"escalations {json.dumps(escal[mode])}, "
            f"{json.dumps(lines[mode])}")
    # host, device and escalation seconds apart, through the library on
    # one lift: run_host, run_device without escalation, run_device with
    # it (the escalation is the difference); the device's seconds hardly
    # depend on the lanes (a step loop), so a few trials do
    trace, meta = hd.capture_and_lift_to_output(sort_paths)
    few = hd.sample_coords(N_SPLIT, meta["window_macro_ops"], seed=0)
    t0 = time.monotonic()
    host = hd.run_host(sort_paths, few)
    host_s = time.monotonic() - t0
    t0 = time.monotonic()
    hd.run_device(trace, meta, few, resolve_diverged=False)
    torch.cuda.synchronize()
    device_s = time.monotonic() - t0
    rep = {}
    t0 = time.monotonic()
    dev = hd.run_device(trace, meta, few, paths=sort_paths, report=rep)
    escalation_s = time.monotonic() - t0 - device_s
    split = {"uops": int(trace.n), "host_s": host_s, "device_s": device_s,
             "escalation_s": escalation_s,
             **escalations(rep, "(d) run_device with escalation"),
             "agreement_exact": hd.compare(host, dev)["agreement_exact"]}
    log(f"(d) {N_SPLIT} trials on one lift of {trace.n} µops: host "
        f"{host_s:.1f} s, device {device_s:.1f} s, escalation "
        f"{escalation_s:.1f} s for {split['escalated_total']} escalated "
        f"trials ({split['diverged_resolved']}); agreement_exact (a "
        f"reading) {split['agreement_exact']} ({card})")
    # run_device over 4096 coordinates: the card against the CPU, lane for
    # lane, on the same lift
    coords = hd.sample_coords(N_HOSTDIFF, meta["window_macro_ops"], seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    on_card = hd.run_device(trace, meta, coords, resolve_diverged=False)
    torch.cuda.synchronize()
    t_card = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.monotonic()
    on_cpu = hd.run_device(trace, meta, coords, resolve_diverged=False,
                           device="cpu")
    t_cpu = time.monotonic() - t0
    if not np.array_equal(on_card, on_cpu):
        fail(f"(d) run_device: {int((on_card != on_cpu).sum())} of "
             f"{N_HOSTDIFF} lanes differ between the card and the CPU")
    # the memmap dense replay per step, beside the same window without it
    faults = hd.coord_faults(meta, coords, "cuda")
    k_mm = TrialKernel(trace, O3Config(enable_shrewd=False), device="cuda",
                       memmap=hd.memmap_from_meta(meta))
    k_plain = TrialKernel(trace, O3Config(enable_shrewd=False),
                          device="cuda")
    # one timed call each, no warm-up run (the dense replay has run on
    # the card in phase 5)
    mm_ms = time_ms(torch, lambda: k_mm._replay(faults), 1, warm=False)
    plain_replay_ms = time_ms(torch, lambda: k_plain._replay(faults), 1,
                              warm=False)
    del k_mm, k_plain, faults
    log(f"(d) run_device over {N_HOSTDIFF} coordinates: card {t_card:.1f} "
        f"s == CPU {t_cpu:.1f} s lane for lane, peak allocated "
        f"{peak / 2**30:.2f} GiB; dense replay of {N_HOSTDIFF} lanes over "
        f"{trace.n} µops, {trace.mem_words} words: with the memmap "
        f"{mm_ms * 1e3 / trace.n:.1f} µs/step, without "
        f"{plain_replay_ms * 1e3 / trace.n:.1f} µs/step ({card})")
    shutil.rmtree(d, ignore_errors=True)
    timings["hostdiff"] = {
        "cli_s": cli_s, "lines": lines, "escalations": escal,
        "split": {"trials": N_SPLIT, **split},
        "run_device_lanes": N_HOSTDIFF, "run_device_card_s": t_card,
        "run_device_cpu_s": t_cpu, "peak_allocated_bytes": peak,
        "uops": int(trace.n), "mem_words": int(trace.mem_words),
        "memmap_replay_ms": mm_ms, "plain_replay_ms": plain_replay_ms,
        "memmap_us_per_step": mm_ms * 1e3 / trace.n,
        "plain_us_per_step": plain_replay_ms * 1e3 / trace.n}
    timings["ingest_phase_s"] = time.monotonic() - t_phase
    marks("16 (d) hostdiff")
    return {"timings": timings, "launches": launches, "k1_max_err": max_err,
            "k2_max_err": k2_err[0]}


def checkpoint_phase(torch, marks, card) -> dict:
    """Phase 17, a gem5 checkpoint through the port on the card → the
    timings, K1's launches on the checkpoint CLI's path and its largest
    difference from its plain version there.  (a) restore: ``sort.c``'s
    marker window captured, written as an ``m5.cpt`` and restored, the
    emulator run forward from it and the stream lifted, the card's golden
    record held against the capture and the memory checker; (b) the
    campaign CLI on a ``CheckpointSpec`` plan and on a ``TraceFileSpec``
    of the same window; (c) the CLI's ``trace``.  The window depends on
    this machine's gcc, so every gate holds the card against the capture,
    the CPU or K1's plain version, never against a pinned tally."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    from shrewd_tpu_torch.campaign.plan import (CampaignPlan, CheckpointSpec,
                                                TraceFileSpec)
    from shrewd_tpu_torch.ingest import hostdiff as hd
    from shrewd_tpu_torch.ingest.configfile import (find_params,
                                                    load_config_json)
    from shrewd_tpu_torch.ingest.cpt import (load_arch_snapshot,
                                             snapshot_from_capture,
                                             write_arch_snapshot)
    from shrewd_tpu_torch.ingest.lift import read_nativetrace
    from shrewd_tpu_torch.ingest.statsfile import load_stats_txt
    from shrewd_tpu_torch.ingest.warm import window_from_snapshot_lifted
    from shrewd_tpu_torch.main import main as cli
    from shrewd_tpu_torch.models.o3 import O3Config
    from shrewd_tpu_torch.ops import taint_cuda, trial
    from shrewd_tpu_torch.ops.taint_cuda import taint_fast_cuda
    from shrewd_tpu_torch.ops.trial import TrialKernel
    from shrewd_tpu_torch.trace import format as tf
    from shrewd_tpu_torch.utils import debug
    from shrewd_tpu_torch.utils.memchecker import check_trace

    t_phase = time.monotonic()
    d = tempfile.mkdtemp(prefix="chip_smoke_cpt_")
    secs: dict = {}

    # (a) restore: phase 16 built sort.c and the tracer (build_tools
    # reuses them); one capture, run alone
    paths = hd.build_tools("workloads/sort.c")
    binary = str(paths.workload)
    t0 = time.monotonic()
    cap = os.path.join(d, "window.bin")
    subprocess.run([str(paths.tracer), cap, f"{paths.begin:x}",
                    f"{paths.end:x}", "2000000", binary], check=True,
                   capture_output=True, text=True)
    nt = read_nativetrace(cap)
    secs["capture_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    cpt_dir = os.path.join(d, "cpt")
    write_arch_snapshot(cpt_dir, snapshot_from_capture(nt))
    snap = load_arch_snapshot(cpt_dir)
    secs["restore_s"] = time.monotonic() - t0
    image = np.concatenate([np.frombuffer(b, np.uint8) for _, b in
                            nt.regions])
    if (snap.pc != int(nt.steps[0][16])
            or not np.array_equal(snap.int_regs[:16], nt.steps[0][:16])
            or not np.array_equal(snap.mem, image)
            or [v for v, _ in snap.regions] != [v for v, _ in nt.regions]):
        fail("(a) the restored snapshot is not the capture's state")
    n = len(nt.steps) - 1
    t0 = time.monotonic()
    trace, meta = window_from_snapshot_lifted(snap, binary, max_steps=n)
    secs["emulate_lift_s"] = time.monotonic() - t0
    if meta["emu_steps"] != n or meta["stats"]["lift_rate"] < 0.95:
        fail(f"(a) emulator ran {meta['emu_steps']} of {n} steps "
             f"({meta['emu_stop_reason']}), lift rate "
             f"{meta['stats']['lift_rate']}")
    t0 = time.monotonic()
    kernel = TrialKernel(trace, O3Config(enable_shrewd=False), device="cuda")
    g = kernel.golden
    torch.cuda.synchronize()
    secs["golden_s"] = time.monotonic() - t0
    if bool(g.diverged.any()) or bool(g.trapped.any()):
        fail("(a) the card's golden replay of the restored window "
             "diverged or trapped")
    want = nt.steps[n][:16].astype(np.uint64) & np.uint64(0xFFFFFFFF)
    if not np.array_equal(g.reg[0, :16].cpu().numpy(),
                          want.astype(np.int64)):
        fail("(a) the card's golden GPRs differ from the capture's last "
             "step")
    t0 = time.monotonic()
    checked = check_trace(trace, golden_record=kernel.golden_rec)
    secs["memcheck_s"] = time.monotonic() - t0
    if checked.n_violations or not checked.n_loads:
        fail(f"(a) memchecker on the card's golden record: "
             f"{checked.n_violations} of {checked.n_loads} loads "
             f"({checked.detail})")
    del kernel, g
    restore = {"steps": n, "uops": int(trace.n), "nphys": int(trace.nphys),
               "mem_words": int(trace.mem_words),
               "image_bytes": int(snap.mem.size),
               "regions": len(snap.regions),
               "lift_rate": meta["stats"]["lift_rate"],
               "loads_checked": checked.n_loads, **secs}
    log(f"(a) sort.c's marker window: {n} steps over {len(snap.regions)} "
        f"regions ({snap.mem.size} bytes) captured in "
        f"{secs['capture_s']:.1f} s, written as m5.cpt and restored in "
        f"{secs['restore_s']:.2f} s (pc, 16 GPRs, image == the capture's); "
        f"emulated {n} steps and lifted to {trace.n} µops (nphys "
        f"{trace.nphys}, {trace.mem_words} words, lift rate "
        f"{meta['stats']['lift_rate']}) in {secs['emulate_lift_s']:.1f} s; "
        f"the card's golden record in {secs['golden_s']:.1f} s: no "
        f"divergence or trap, 16 GPRs == the capture's last step; "
        f"memchecker {checked.n_loads} loads clean in "
        f"{secs['memcheck_s']:.1f} s ({card})")
    marks("17 (a) restore")

    # (b) the campaign CLI on the CheckpointSpec plan (counted), then on a
    # TraceFileSpec of the same window under the same name and seed
    npz = os.path.join(d, "window.npz")
    tf.save(npz, trace, meta={"source": "checkpoint"})
    base = dict(structures=["regfile", "fu"], batch_size=CPT_BATCH,
                target_halfwidth=CPT_TARGET, stratify=True, seed=0)
    plans = {"checkpoint": CampaignPlan(simpoints=[CheckpointSpec(
        name="cpt", cpt_dir=cpt_dir, binary=binary, max_steps=n)], **base),
             "trace file": CampaignPlan(simpoints=[TraceFileSpec(
                 name="cpt", path=npz)], **base)}
    sizes: list = []
    kept: list = []
    plain_cuda = [0]
    launch, plain = trial.taint_fast_cuda, taint_cuda.taint_fast_plain

    def sized(*a, **kw):
        got = launch(*a, **kw)
        sizes.append(int(a[3].kind.shape[0]))
        if sizes[-1] == CPT_BATCH and not kept:
            kept.append((a, {x: v for x, v in kw.items() if x != "stream"},
                         got))
        return got

    def counted_plain(*a, **kw):
        if a[3].kind.device.type == "cuda":
            plain_cuda[0] += 1
        return plain(*a, **kw)

    runs: dict = {}
    for name, plan in plans.items():
        plan_path = os.path.join(d, f"{name.replace(' ', '_')}.json")
        plan.dump_json(plan_path)
        out = os.path.join(d, name.replace(" ", "_"))
        if name == "checkpoint":
            trial.taint_fast_cuda = sized
            taint_cuda.taint_fast_plain = counted_plain
            taint_fast_cuda.launches = 0
        t0 = time.monotonic()
        rc = cli(["run", plan_path, "--outdir", out])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        if name == "checkpoint":
            n_k1 = taint_fast_cuda.launches
        trial.taint_fast_cuda = launch
        taint_cuda.taint_fast_plain = plain
        if rc != 0:
            fail(f"(b) {name} plan: CLI rc {rc}")
        stats = _read_json(os.path.join(out, "stats.json"))
        doc = _read_json(os.path.join(out, "campaign_ckpt",
                                      "campaign.json"))
        per = {s: {"trials": stats["cpt"][s]["trials"],
                   "outcomes": stats["cpt"][s]["outcomes"]}
               for s in base["structures"]}
        runs[name] = {"wall_s": wall, "results": per, "doc": doc,
                      "out": out, "stats": stats}
    ckpt = runs["checkpoint"]
    if ckpt["results"] != runs["trace file"]["results"]:
        fail(f"(b) the CheckpointSpec plan's results {ckpt['results']} != "
             f"the TraceFileSpec plan's {runs['trace file']['results']}")
    doc = ckpt["doc"]
    batches = trials = 0
    for s, st in doc["state"]["cpt"].items():
        batches += st["next_batch"]
        trials += sum(st["tallies"])
        if st["tier_trials"][1:] != [0, 0]:
            fail(f"(b) {s}: tier trials {st['tier_trials']}")
    mon = doc["integrity"]
    want_k1 = batches + 2 * mon["canary_runs"] + mon["audit_batches"]
    if (n_k1 != len(sizes) or not sizes or len(sizes) != want_k1
            or sizes.count(CPT_BATCH) != batches):
        fail(f"(b) K1 launches {n_k1} "
             f"({sizes.count(CPT_BATCH)} of {CPT_BATCH} lanes) != "
             f"{batches} batches + 2 x {mon['canary_runs']} canary runs + "
             f"{mon['audit_batches']} audit samples")
    if plain_cuda[0]:
        fail("(b) K1's plain version ran on card tensors")
    if not kept:
        fail("(b) no batch launch of K1 was kept")
    args, kw, got = kept[0]
    max_err = compare(torch, got, plain(*args, **kw), "(b) first batch")
    blocks = load_stats_txt(os.path.join(ckpt["out"], "stats.txt"))
    for s in base["structures"]:
        if blocks[-1][f"campaign.cpt.{s}.trials"] != \
                ckpt["stats"]["cpt"][s]["trials"]:
            fail(f"(b) stats.txt's {s} trials != stats.json's")
    cfg = load_config_json(os.path.join(ckpt["out"], "config.json"))
    if find_params(cfg, "structures") != [("structures",
                                           base["structures"])]:
        fail(f"(b) config.json's structures: "
             f"{find_params(cfg, 'structures')}")
    campaign = {"batches": batches, "trials": trials,
                "wall_s": ckpt["wall_s"],
                "trials_per_s": trials / ckpt["wall_s"],
                "trace_file_wall_s": runs["trace file"]["wall_s"],
                "k1_launches": len(sizes),
                "canary_runs": mon["canary_runs"],
                "audit_batches": mon["audit_batches"],
                "results": ckpt["results"]}
    log(f"(b) CLI on the CheckpointSpec plan (regfile, fu; batch "
        f"{CPT_BATCH}, stratified, target {CPT_TARGET}): rc 0, {batches} "
        f"batches, {trials} trials in {ckpt['wall_s']:.1f} s = "
        f"{trials / ckpt['wall_s']:,.0f} trials/s, every batch on the "
        f"device tier, K1 {len(sizes)} launches = {batches} batches + 2 x "
        f"{mon['canary_runs']} canary runs + {mon['audit_batches']} audit "
        f"samples, 0 plain calls, K1 == plain on the first batch; results "
        f"== the TraceFileSpec plan's ({runs['trace file']['wall_s']:.1f} "
        f"s) {json.dumps(ckpt['results'])}; stats.txt and config.json read "
        f"back ({card})")
    marks("17 (b) checkpoint campaign CLI")

    # (c) the CLI's trace: on the card, and -n 64 --all against the CPU
    lines = {}
    trace_s = {}
    for label, argv, want in (
            ("all", ["-n", "64", "--all"], 64),
            ("all cpu", ["-n", "64", "--all", "--platform", "cpu"], 64),
            ("pipeline", ["--pipeline", "-n", "32"], 33),
            ("workload", ["--workload", "workloads/sort.c", "-n", "16"],
             16)):
        buf = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            rc = cli(["trace", *argv])
        torch.cuda.synchronize()
        trace_s[label] = time.monotonic() - t0
        lines[label] = buf.getvalue()
        if rc != 0 or len(lines[label].splitlines()) != want:
            fail(f"(c) trace {' '.join(argv)}: rc {rc}, "
                 f"{len(lines[label].splitlines())} lines, not {want}")
    debug.disable("Exec", "ExecResult", "ExecOpClass")
    if lines["all"] != lines["all cpu"]:
        fail("(c) trace -n 64 --all on the card != --platform cpu")
    log(f"(c) trace -n 64 --all ({trace_s['all']:.1f} s) byte-equal to "
        f"--platform cpu ({trace_s['all cpu']:.1f} s); --pipeline -n 32 "
        f"({trace_s['pipeline']:.1f} s) and --workload sort.c -n 16 "
        f"({trace_s['workload']:.1f} s): rc 0, the lines asked for")
    shutil.rmtree(d, ignore_errors=True)
    timings = {"card": card, "restore": restore, "campaign": campaign,
               "trace_s": trace_s,
               "checkpoint_phase_s": time.monotonic() - t_phase}
    marks("17 (c) trace CLI")
    return {"timings": timings, "launches": {"checkpoint CLI": len(sizes)},
            "k1_max_err": max_err}


def matrix_doc() -> dict:
    """Phase 18 (b)'s scenario matrix: the flagship window at full width,
    regfile plus the coherence tiers at the plan's defaults, parity over
    secded in a strict-priority class above it, two thermal envelopes."""
    return {
        "tag": MATRIX_TAG, "seed": 0,
        "workloads": [{"name": "flagship", "simpoints": [{
            "type": "WorkloadSpec", "name": "flagship",
            "workload": dict(FLAGSHIP)}]}],
        "targets": ["regfile", "mesi:state", "noc:router"],
        "schemes": [{"name": "parity", "detect": 1.0, "area": 1.03,
                     "priority": 1},
                    {"name": "secded", "correct": 1.0, "area": 1.22}],
        "thermal": [{"name": "tnom"},
                    {"name": "hot", "temperature_c": 100.0}],
        "base": {"batch_size": MATRIX_BATCH, "stratify": True,
                 "target_halfwidth": MATRIX_TARGET,
                 "max_trials": MATRIX_MAX_TRIALS},
        "sdc_target": 0.0, "fit_per_bit": 1e-3}


def four_node_network(mod):
    """Phase 18 (a)'s thermal network: four die blocks in a ring, each
    tied to ambient (tests/test_torch_thermal.py ``four_node``)."""
    net = mod.ThermalNetwork(n_nodes=4, ambient_c=45.0, step_s=0.005)
    for i in range(4):
        net.resistor(i, (i + 1) % 4, 0.8 + 0.1 * i)
        net.resistor(i, -1, 2.0 + 0.5 * i)
        net.capacitor(i, -1, 0.3 + 0.05 * i)
    return net


def matrix_phase(torch, marks, card) -> dict:
    """Phase 18, the protection search, the thermal network and the
    scenario matrix on the card → the timings, K1's launches on each
    path and K1's largest difference from its plain version."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    from shrewd_tpu_torch import native
    from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
    from shrewd_tpu_torch.campaign.plan import CampaignPlan
    from shrewd_tpu_torch.models.o3 import O3Config
    from shrewd_tpu_torch.obs import metrics as obs_metrics
    from shrewd_tpu_torch.ops import taint_cuda, trial
    from shrewd_tpu_torch.ops.taint_cuda import taint_fast_cuda
    from shrewd_tpu_torch.ops.trial import TrialKernel
    from shrewd_tpu_torch.parallel import exec_cache
    from shrewd_tpu_torch.scenario import ScenarioMatrix
    from shrewd_tpu_torch.search import protect as PS
    from shrewd_tpu_torch.service import journal as journal_mod
    from shrewd_tpu_torch.service import scheduler as sched_mod
    from shrewd_tpu_torch.tools import scenario as scenario_cli
    from shrewd_tpu_torch.utils import prng
    from shrewd_tpu_torch.utils import thermal as TH

    timings: dict = {"card": card}
    launches: dict = {}
    t_phase = time.monotonic()
    # instrumentation, as in phase 13: every K1 launch's lane count, the
    # first launch of each lane count kept, calls of the plain version
    # on card tensors
    sizes: list = []
    kept: dict = {}
    launch = trial.taint_fast_cuda
    plain = taint_cuda.taint_fast_plain

    def sized(*a, **kw):
        got = launch(*a, **kw)
        n = int(a[3].kind.shape[0])
        sizes.append(n)
        if n not in kept:
            kept[n] = (a, {x: v for x, v in kw.items() if x != "stream"},
                       got)
        return got

    plain_cuda = [0]

    def counted_plain(*a, **kw):
        if a[3].kind.device.type == "cuda":
            plain_cuda[0] += 1
        return plain(*a, **kw)

    trial.taint_fast_cuda = sized
    taint_cuda.taint_fast_plain = counted_plain
    max_err = 0

    # (a) the protection search, card against CPU: seeded profiles, 6
    # structures x 4 schemes
    rng = np.random.default_rng(0)
    profiles = [PS.StructureProfile.from_tally(
        f"s{i}", int(rng.integers(64, 20000)), rng.integers(1, 400, 4),
        fit_per_bit=float(rng.uniform(1e-4, 1e-2)))
        for i in range(SEARCH_STRUCTURES)]
    schemes = [PS.NONE, PS.PARITY, PS.SECDED,
               PS.Scheme("shadow", 0.6, 0.0, 1.5, detect_sdc=0.45,
                         detect_due=0.7)]
    t0 = time.monotonic()
    ds = PS.DesignSpace(profiles, schemes=schemes, device="cuda")
    res_card = ds.search(1e-3)
    torch.cuda.synchronize()
    t_card = time.monotonic() - t0
    t0 = time.monotonic()
    ds_cpu = PS.DesignSpace(profiles, schemes=schemes, device="cpu")
    res_cpu = ds_cpu.search(1e-3)
    t_cpu = time.monotonic() - t0
    cfgs = ds.enumerate()
    rates = [(a.cpu().numpy(), b.numpy()) for a, b in
             zip(ds.evaluate(cfgs), ds_cpu.evaluate(cfgs))]
    search_err = max(float(np.max(np.abs(a - b) / np.maximum(np.abs(b),
                                                             1e-30)))
                     for a, b in rates)
    if len(cfgs) != 4 ** SEARCH_STRUCTURES or search_err > 1e-6:
        fail(f"(a) DesignSpace: {len(cfgs)} configs, card rates off the "
             f"CPU's by rtol {search_err}")
    if (res_card.feasible, res_card.assignment,
            [p[2] for p in res_card.pareto]) != (
            res_cpu.feasible, res_cpu.assignment,
            [p[2] for p in res_cpu.pareto]):
        fail("(a) DesignSpace: the card's search differs from the CPU's")
    log(f"(a) DesignSpace {SEARCH_STRUCTURES} structures x 4 schemes = "
        f"{len(cfgs)} configs: card == CPU (rates within rtol "
        f"{search_err:.2e}), front of {len(res_card.pareto)}; search "
        f"card {t_card:.3f} s, CPU {t_cpu:.3f} s")
    # the thermal trajectory, card against CPU
    power = np.random.default_rng(1).uniform(0.0, 6.0, (THERMAL_STEPS, 4))
    th_card = four_node_network(TH).build(device="cuda")
    th_card.trajectory(power[:8])              # warm the solver
    torch.cuda.synchronize()
    t0 = time.monotonic()
    traj = th_card.trajectory(power)
    torch.cuda.synchronize()
    t_th_card = time.monotonic() - t0
    t0 = time.monotonic()
    traj_cpu = four_node_network(TH).build(device="cpu").trajectory(power)
    t_th_cpu = time.monotonic() - t0
    th_err = float((traj.cpu() - traj_cpu).abs().div(
        traj_cpu.abs()).max())
    if th_err > 1e-5 or not bool(torch.isfinite(traj).all()):
        fail(f"(a) thermal: card off the CPU by rtol {th_err}")
    log(f"(a) thermal 4 nodes x {THERMAL_STEPS} steps: card == CPU within "
        f"rtol {th_err:.2e}; card {t_th_card:.2f} s "
        f"({t_th_card / THERMAL_STEPS * 1e6:.1f} µs a step), CPU "
        f"{t_th_cpu:.2f} s")
    # shadow_scheme with keys on the flagship window: one unprotected fu
    # batch through the hybrid path, K1 counted from 0
    trace = native.generate_trace(**FLAGSHIP)
    kernel = TrialKernel(trace, O3Config(shadow_model="fupool"),
                         device="cuda")
    keys = prng.trial_keys(prng.campaign_key(0), SHADOW_KEYS)
    sizes.clear()
    kept.clear()
    taint_fast_cuda.launches = 0
    t0 = time.monotonic()
    scheme = PS.shadow_scheme(kernel, keys=keys)
    torch.cuda.synchronize()
    t_shadow = time.monotonic() - t0
    n_shadow = taint_fast_cuda.launches
    if n_shadow != 1 or sizes != [SHADOW_KEYS]:
        fail(f"(a) shadow_scheme: K1 launched {n_shadow} times "
             f"({sizes}), not once for its {SHADOW_KEYS}-lane batch")
    args, kw, got = kept[SHADOW_KEYS]
    max_err = max(max_err, compare(torch, got, plain(*args, **kw),
                                   "shadow_scheme fu batch"))
    if not (0.0 < scheme.detect <= 1.0) or scheme.detect_sdc is None:
        fail(f"(a) shadow_scheme: {scheme}")
    launches["shadow_scheme fu"] = n_shadow
    log(f"(a) shadow_scheme(keys={SHADOW_KEYS}) on the flagship window: "
        f"{scheme}; 1 K1 launch == plain bitwise; {t_shadow:.1f} s")
    del kernel
    timings["search"] = {
        "configs": len(cfgs), "card_s": t_card, "cpu_s": t_cpu,
        "max_rel_err": search_err}
    timings["thermal"] = {
        "nodes": 4, "steps": THERMAL_STEPS, "card_s": t_th_card,
        "cpu_s": t_th_cpu, "us_per_step_card": t_th_card / THERMAL_STEPS
        * 1e6, "max_rel_err": th_err}
    timings["shadow_scheme"] = {"keys": SHADOW_KEYS, "s": t_shadow,
                                "detect": scheme.detect,
                                "detect_sdc": scheme.detect_sdc,
                                "detect_due": scheme.detect_due}
    marks("18 (a) search, thermal, shadow_scheme")

    # (b) the matrix through the CLI, in process.  Each tenant tick is
    # timed (CUDA-synchronized) and every journal record is kept.
    d = tempfile.mkdtemp(prefix="chip_smoke_matrix_")
    path = os.path.join(d, "m.json")
    with open(path, "w") as f:
        json.dump(matrix_doc(), f)
    outdir = os.path.join(d, "out")
    tick_s: dict = {}
    tick_real = sched_mod.CampaignScheduler._tick_tenant

    def timed_tick(self, t):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        tick_real(self, t)
        torch.cuda.synchronize()
        tick_s[t.spec.name] = tick_s.get(t.spec.name, 0.0) + (
            time.monotonic() - t0)

    records: list = []
    append_real = journal_mod.FleetJournal.append

    def kept_append(self, kind, data=None):
        records.append((kind, json.loads(json.dumps(data or {}))))
        return append_real(self, kind, data)

    sched_mod.CampaignScheduler._tick_tenant = timed_tick
    journal_mod.FleetJournal.append = kept_append
    exec_cache.clear_kernels()
    compiled0 = exec_cache.cache().compiled
    sizes.clear()
    kept.clear()
    plain_cuda[0] = 0
    taint_fast_cuda.launches = 0
    err = io.StringIO()
    t0 = time.monotonic()
    try:
        with contextlib.redirect_stderr(err):
            rc = scenario_cli.main(["--plan", path, "--serve", "--outdir",
                                    outdir, "--pareto-every", "1"])
        torch.cuda.synchronize()
    finally:
        sched_mod.CampaignScheduler._tick_tenant = tick_real
        journal_mod.FleetJournal.append = append_real
    wall = time.monotonic() - t0
    n_matrix = taint_fast_cuda.launches
    matrix_sizes = list(sizes)
    compiled = exec_cache.cache().compiled - compiled0
    if rc != 0:
        fail(f"(b) scenario --serve rc {rc}: {err.getvalue()[-2000:]}")
    art_path = os.path.join(outdir, f"PARETO_{MATRIX_TAG}.json")
    art = _read_json(art_path)
    fleet = _read_json(os.path.join(outdir, "fleet_ckpt", "fleet.json"))
    tenants = {t["spec"]["name"]: t for t in fleet["tenants"]}
    if len(tenants) != 12:
        fail(f"(b) {len(tenants)} tenants, not the 12 cells")
    statuses = {n: t["status"] for n, t in tenants.items()}
    if set(statuses.values()) - {"complete", "pruned"}:
        fail(f"(b) statuses {statuses}")
    # every prune group whose parity cell converged: its secded mate is
    # pruned by it through a journaled revoke
    revokes = {r["tenant"]: r["reason"] for k, r in records
               if k == "revoke"}
    pruned = sorted(n for n, s in statuses.items() if s == "pruned")
    for name, t in tenants.items():
        if ".parity." not in name or t["status"] != "complete":
            continue
        (row,) = t["results"].values()
        mate = name.replace(".parity.", ".secded.")
        if row["converged"] and (statuses[mate] != "pruned"
                                 or revokes.get(mate)
                                 != f"pareto:{name}"):
            fail(f"(b) {mate}: {statuses[mate]}, revoke "
                 f"{revokes.get(mate)!r}, though {name} converged first")
    if not pruned or set(pruned) != set(revokes):
        fail(f"(b) pruned {pruned}, journaled revokes {sorted(revokes)}")
    if sorted(d["cell"] for d in art["decisions"]) != pruned:
        fail(f"(b) the artifact's decisions {art['decisions']} != the "
             f"pruned cells {pruned}")
    # thermal mates' raw tallies: equal but for the NoC cells
    by_mate: dict = {}
    for name, t in tenants.items():
        if t["status"] == "complete":
            key = name.rsplit(".", 1)[0]
            by_mate.setdefault(key, []).append(t["results"])
    for key, rows in by_mate.items():
        same = all(r == rows[0] for r in rows)
        if ".noc+router." not in key and len(rows) == 2 and not same:
            fail(f"(b) {key}: thermal mates' raw tallies differ")
    # every batch on the device tier, integrity clean; K1's launches
    o3 = [n for n in tenants if ".regfile." in n]
    batches = canaries = audits = 0
    for name in tenants:
        tdir = os.path.join(outdir, "tenants", name)
        ckpt = os.path.join(tdir, "campaign_ckpt", "campaign.json")
        if not os.path.exists(ckpt):
            continue            # pruned before it was elaborated
        doc = _read_json(ckpt)
        stats = _read_json(os.path.join(tdir, "stats.json"))
        tiers = stats["resilience"]["tier_trials"]
        ig = stats["integrity"]
        bad = {k: ig[k] for k in ("canary_failures", "invariant_violations",
                                  "audit_mismatches", "quarantined_batches")
               if ig[k]}
        if tiers["cpu"] or tiers["oracle"] or bad:
            fail(f"(b) {name}: tier trials {tiers}, integrity {bad}")
        if name in o3:
            for st in doc["state"].values():
                for s in st.values():
                    batches += s["next_batch"]
            canaries += doc["integrity"]["canary_runs"]
            audits += doc["integrity"]["audit_batches"]
    other = sorted({n for n in matrix_sizes} - {MATRIX_BATCH, 3, 2})
    want = {MATRIX_BATCH: batches, 3: canaries, 2: canaries}
    if audits:
        if len(other) != 1:
            fail(f"(b) K1 lane counts {sorted(set(matrix_sizes))}")
        want[other[0]] = audits
    got_sizes = {n: matrix_sizes.count(n) for n in set(matrix_sizes) |
                 set(want)}
    if got_sizes != want or n_matrix != len(matrix_sizes) or not batches:
        fail(f"(b) K1 launches by lane count {got_sizes} != the O3 cells' "
             f"batches, canaries and audit samples {want} (counter "
             f"{n_matrix})")
    if plain_cuda[0]:
        fail("(b) K1's plain version ran on card tensors")
    args, kw, got = kept[MATRIX_BATCH]
    max_err = max(max_err, compare(torch, got, plain(*args, **kw),
                                   "matrix regfile batch"))
    if compiled != 1:
        fail(f"(b) the kernel registry built {compiled} kernels, not 1 "
             "for the one window and machine config of the O3 cells")
    # metrics.json and the Prometheus text read back
    snap = obs_metrics.read(outdir)
    with open(os.path.join(outdir, "metrics.prom")) as f:
        prom = f.read()
    if snap != _read_json(os.path.join(outdir, "metrics.json")) or \
            prom != obs_metrics.prometheus_text(snap):
        fail("(b) metrics.json / metrics.prom do not read back")
    launches["scenario matrix O3 cells"] = n_matrix
    marks("18 (b) scenario matrix")
    # one completed O3 cell and one completed coherence cell against a
    # solo serial run of the cell's plan on the card
    cells = {c.name: c for c in
             ScenarioMatrix.from_dict(matrix_doc()).expand()}
    solo_s = {}
    for family in (".regfile.", ".mesi+state."):
        name = next(n for n in sorted(tenants) if family in n
                    and tenants[n]["status"] == "complete")
        t0 = time.monotonic()
        orch = Orchestrator(CampaignPlan.from_dict(cells[name].plan))
        list(orch.events())
        solo_s[name] = time.monotonic() - t0
        solo = {f"{sp}/{st}": r.tallies.tolist()
                for (sp, st), r in orch.results.items()}
        if solo != {k: v["tallies"] for k, v in
                    tenants[name]["results"].items()}:
            fail(f"(b) {name}: fleet tallies != its solo serial run")
    # per-family seconds a batch, from the timed ticks
    fam: dict = {}
    for name, t in tenants.items():
        family = cells[name].target.split(":")[0]
        f = fam.setdefault(family, {"tenants": 0, "batches": 0, "s": 0.0})
        f["tenants"] += 1
        f["batches"] += t["batches"]
        f["s"] += tick_s.get(name, 0.0)
    for f in fam.values():
        f["s_per_batch"] = f["s"] / f["batches"] if f["batches"] else None
    counts = {x: list(statuses.values()).count(x)
              for x in set(statuses.values())}
    log(f"(b) matrix {MATRIX_TAG!r}: rc 0, 12 cells {counts}, "
        f"pruned {pruned} by journaled revokes; regfile and mesi thermal "
        f"mates equal; one kernel built; K1 {n_matrix} launches == "
        f"{batches} batches + 2 x {canaries} canary runs + {audits} audit "
        f"samples, == plain on the first batch; solo runs equal "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in solo_s.items())}); "
        f"wall {wall:.1f} s; per family {fam} ({card})")
    # (c) --status and --pareto on that directory
    status = json.loads(_cli_stdout(scenario_cli.main,
                                    ["--status", outdir]))
    if status["tag"] != MATRIX_TAG or set(status["tenants"]) != set(
            tenants):
        fail(f"(c) --status: {status}")
    before = _read_json(art_path)
    _cli_stdout(scenario_cli.main, ["--pareto", outdir])
    again = _read_json(art_path)
    before["fleet"].pop("ticks"), again["fleet"].pop("ticks")
    if again != before:
        fail("(c) --pareto re-emitted another artifact than (b)'s")
    log("(c) --status and --pareto: rc 0, the re-emitted artifact == (b)'s")
    trial.taint_fast_cuda = launch
    taint_cuda.taint_fast_plain = plain
    shutil.rmtree(d, ignore_errors=True)
    timings["matrix"] = {
        "wall_s": wall, "tenants": 12, "statuses": statuses,
        "pruned": pruned, "batches": {n: t["batches"]
                                      for n, t in tenants.items()},
        "families": fam, "k1_launches": n_matrix, "o3_batches": batches,
        "canary_runs": canaries, "audit_batches": audits,
        "kernels_built": compiled, "solo_s": solo_s}
    timings["matrix_phase_s"] = time.monotonic() - t_phase
    marks("18 (c) status + pareto")
    return {"timings": timings, "launches": launches, "k1_max_err": max_err}


def _cli_stdout(main, argv) -> str:
    """Run one of the port's CLI ``main``s in-process; rc 0 or fail; its
    standard output."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    if rc != 0:
        fail(f"{argv}: rc {rc}: {err.getvalue()[-2000:]}")
    return out.getvalue()


def escalations(rep: dict, what: str) -> dict:
    """A hostdiff report's emulator escalations; fails when the emulator
    could not run (``run_device`` then labels every escalated trial SDC)
    or when it classified fewer trials than were escalated."""
    if "diverged_resolution_failed" in rep:
        fail(f"{what}: the emulator escalation failed: "
             f"{rep['diverged_resolution_failed']}")
    resolved = rep.get("diverged_resolved", {})
    if sum(resolved.values()) != rep["escalated_total"]:
        fail(f"{what}: {sum(resolved.values())} of "
             f"{rep['escalated_total']} escalated trials classified")
    return {"device_diverged": rep["device_diverged"],
            "resync_severed": rep["resync_severed"],
            "escalated_total": rep["escalated_total"],
            "diverged_resolved": resolved}


def start_lanes() -> str:
    """Start one child process of this script for each lane of ``LANES``
    → the directory that takes their output and results.  Each child is
    the leader of a process group of its own, which ``stop_lanes`` kills
    whole."""
    import atexit
    import os
    import tempfile

    d = tempfile.mkdtemp(prefix="chip_smoke_lanes_")
    atexit.register(stop_lanes)
    for name in LANES:
        base = os.path.join(d, name)
        with open(base + ".out", "w") as out, open(base + ".err", "w") as err:
            _lanes.append((name, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--lane", name,
                 base + ".json"], stdout=out, stderr=err,
                start_new_session=True)))
    return d


def stop_lanes() -> None:
    """Kill every lane's process group (a lane that failed may leave
    processes it started) and reap the lanes."""
    import os
    import signal

    for _, proc in _lanes:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        proc.wait()


def join_lanes(d: str, t_start: float) -> dict:
    """Wait for every lane, print its output and fail if it failed → the
    results of its phases by function name, and each lane's seconds."""
    import os
    import shutil

    results: dict = {"lane_s": {}}
    for name, proc in _lanes:
        left = t_start + LANE_TIMEOUT_S - time.monotonic()
        try:
            rc = proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            rc = None
        base = os.path.join(d, name)
        log(f"lane {name} (phase {LANE_PHASES[name]}), run in a child "
            "process beside phases 11, 12 and 15:")
        with open(base + ".out") as f:
            sys.stdout.write(f.read())
        with open(base + ".err") as f:
            sys.stderr.write(f.read())
        sys.stdout.flush()
        sys.stderr.flush()
        if rc is None:
            stop_lanes()
            fail(f"lane {name} still running {LANE_TIMEOUT_S} s after the "
                 "lanes started")
        if rc != 0:
            fail(f"lane {name} (phase {LANE_PHASES[name]}) exited rc {rc}")
        doc = _read_json(base + ".json")
        results.update(doc["phases"])
        results["lane_s"][name] = doc["wall_s"]
    stop_lanes()
    shutil.rmtree(d, ignore_errors=True)
    return results


def lane_main(name: str, result: str) -> int:
    """``--lane NAME RESULT``: run one lane's phases in order in this child
    process and write their results to RESULT as JSON.  The parent built
    the kernel and the oracle first, so the builds here find them."""
    import os
    import signal
    import threading

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from shrewd_tpu_torch import native
    from shrewd_tpu_torch.ops import taint_cuda

    parent = os.getppid()

    def orphaned() -> None:
        # the parent is gone (killed at its time limit): take this lane's
        # process group with it
        while os.getppid() == parent:
            time.sleep(1.0)
        os.killpg(0, signal.SIGKILL)

    threading.Thread(target=orphaned, daemon=True).start()
    # the lanes' CPU kernels are small step loops: one intra-op thread
    # each, so that three processes' thread pools do not spin against
    # one another
    torch.set_num_threads(1)
    t0 = time.monotonic()
    taint_cuda.build()
    native.build()
    card = card_line()
    t_mark = [t0]

    def marks(phase: str) -> None:
        now = time.monotonic()
        log(f"phase {phase}: {now - t_mark[0]:.1f} s")
        t_mark[0] = now

    phases = {}
    for fn in LANES[name]:
        t_mark[0] = time.monotonic()
        phases[fn] = globals()[fn](torch, marks, card)
    tmp = f"{result}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump({"phases": phases, "wall_s": time.monotonic() - t0}, f)
    os.replace(tmp, result)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    try:
        from shrewd_tpu_torch import native
    except ModuleNotFoundError as e:
        # run from a directory that holds this script alone: the port it
        # drives is not there
        print(f"chip_smoke: {e}; run this script from the root of the "
              "repository", file=sys.stderr)
        return 2
    from shrewd_tpu_torch.isa import uops as U
    from shrewd_tpu_torch.models.o3 import O3Config, compute_shadow_cov
    from shrewd_tpu_torch.ops import classify as C
    from shrewd_tpu_torch.ops import taint_cuda
    from shrewd_tpu_torch.ops.taint import record_golden, taint_fast_plain
    from shrewd_tpu_torch.ops.taint_cuda import taint_fast_cuda
    from shrewd_tpu_torch.ops.trial import TrialKernel
    from shrewd_tpu_torch.utils import prng

    t_mark = [time.monotonic()]

    def marks(phase: str) -> None:
        now = time.monotonic()
        log(f"phase {phase}: {now - t_mark[0]:.1f} s")
        t_mark[0] = now

    # 1. environment
    nvcc_v = subprocess.run([taint_cuda.nvcc(), "--version"],
                            capture_output=True, text=True,
                            check=True).stdout.strip().splitlines()[-1]
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} | {nvcc_v}")
    log(card)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 2. build
    t0 = time.monotonic()
    taint_cuda.build(verbose=True)
    t_kernel = time.monotonic() - t0
    t0 = time.monotonic()
    native.build()
    log(f"build: taint_fast.cu {t_kernel:.1f} s, csrc oracle and chunk "
        f"recorder {time.monotonic() - t0:.1f} s")
    marks("1-2 environment + build")

    # 3. the flagship window
    trace = native.generate_trace(seed=1, n=4096, nphys=256, mem_words=4096,
                                  working_set_words=1024)
    kernel = TrialKernel(trace, O3Config(), device="cuda")
    t0 = time.monotonic()
    gold = kernel.golden_rec
    torch.cuda.synchronize()
    log(f"window n={trace.n} nphys={trace.nphys} mem_words="
        f"{trace.mem_words}: golden record {time.monotonic() - t0:.1f} s, "
        f"mem_t {'on' if gold.mem_t is not None else 'off'}")
    keys = prng.trial_keys(prng.campaign_key(0), N_KEYS)
    t0 = time.monotonic()
    kernel_s = TrialKernel(trace, O3Config(shadow_model="fupool"),
                           device="cuda")
    _ = kernel_s.packed_stream
    torch.cuda.synchronize()
    log(f"the same window with O3Config(shadow_model='fupool'): scoreboard, "
        f"FU pool and golden record {time.monotonic() - t0:.1f} s, "
        f"coverage > 0 on {int((kernel_s.shadow_cov > 0).sum())} of "
        f"{trace.n} µops")
    marks("3 window")

    # 4. kernel vs its plain version on the card
    cfg = kernel.cfg

    # batches (b) and (c) run against a non-zero shadow coverage, so that
    # the FU faults' detection branch and the DETECTED outcome are held too
    mixed_cov = torch.as_tensor(compute_shadow_cov(
        U.opclass_of(trace.opcode),
        O3Config(shadow_coverage=[MIXED_COVERAGE] * U.N_OPCLASSES))[0],
        device=dev)

    def both(kern, faults, k, may_latch, shadow_cov, stream=None):
        setup = kern._setup_batch(faults)
        args = (kern.golden_rec, kern.tr, shadow_cov, faults, *setup)
        kw = dict(k=k, compare_regs=cfg.compare_regs, may_latch=may_latch)
        got = taint_fast_cuda(*args, **kw, stream=stream)
        torch.cuda.synchronize()
        return got, taint_fast_plain(*args, **kw), args, kw

    flag_faults = kernel.sample_batch(keys, "regfile")
    mixed = mixed_faults(torch, trace, N_MIXED, 7, dev)
    max_err = 0
    flagship = None
    # (a) reads the kernel's packed record, as the main path does; (b) and
    # (c), at another coverage, pack their own
    for label, faults, k, ml, cov, stream in (
            ("(a) regfile", flag_faults, cfg.taint_k, False,
             kernel.shadow_cov, kernel.packed_stream),
            ("(b) mixed kinds", mixed, cfg.taint_k, True, mixed_cov, None),
            ("(c) mixed kinds, K=4", mixed, 4, True, mixed_cov, None)):
        t0 = time.monotonic()
        got, ref, args, kw = both(kernel, faults, k, ml, cov, stream)
        max_err = max(max_err, compare(torch, got, ref, label))
        n_ovf = int(got.overflow.sum())
        n_det = int((got.outcome == C.OUTCOME_DETECTED).sum())
        log(f"K1 vs plain {label}: {faults.kind.shape[0]} lanes equal, "
            f"{n_ovf} overflowed, {int(got.escaped.sum())} escaped, "
            f"{n_det} detected ({time.monotonic() - t0:.1f} s)")
        if label.startswith("(a)"):
            flagship = (args, kw, got)
        if label.startswith("(b)") and n_det == 0:
            fail("the mixed-kind batch detected no fault")
        if label.startswith("(c)") and n_ovf == 0:
            fail("the K=4 batch overflowed no set")
    # (d) the flagship window with one loud step, the middle branch's
    # outcome inverted before recording; the regfile lanes of (a)
    taken_d, j_d = loud_branch(trace.taken, trace.opcode)
    kernel_d = TrialKernel(trace._replace(taken=taken_d), O3Config(),
                           device="cuda")
    loud_d = torch.nonzero(~taint_cuda.quiet_steps(
        kernel_d.golden_rec, kernel_d.tr)).flatten().tolist()
    if loud_d != [j_d]:
        fail(f"(d): loud steps {loud_d[:8]}, expected [{j_d}]")
    t0 = time.monotonic()
    got, ref, _, _ = both(kernel_d, flag_faults, cfg.taint_k, False,
                          kernel_d.shadow_cov, kernel_d.packed_stream)
    max_err = max(max_err, compare(torch, got, ref, "(d) loud step"))
    n_stop = int((got.steps == j_d + 1).sum())
    log(f"K1 vs plain (d) loud step {j_d}: {N_KEYS} regfile lanes equal, "
        f"{n_stop} stopped there ({time.monotonic() - t0:.1f} s)")
    if n_stop == 0:
        fail("(d): no lane stopped at the loud step")
    del kernel_d, got, ref
    # (e) the lanes the structure path draws, from the port's own samplers
    # on the fupool kernel: fu, rob, iq and lsq together (may_latch off, as
    # their main path runs), then latch
    from shrewd_tpu_torch.models.o3 import Fault
    sub_keys = keys[:N_STRUCT_MIXED]
    drawn = {s: kernel_s.sample_batch(sub_keys, s)
             for s in ("fu", "rob", "iq", "lsq", "latch")}
    for label, group, ml in (("(e) fu, rob, iq, lsq", ("fu", "rob", "iq",
                                                       "lsq"), False),
                             ("(e) latch", ("latch",), True)):
        faults = Fault(*(torch.cat(parts) for parts in
                         zip(*(drawn[s] for s in group))))
        t0 = time.monotonic()
        got, ref, _, _ = both(kernel_s, faults, cfg.taint_k, ml,
                              kernel_s.shadow_cov, kernel_s.packed_stream)
        max_err = max(max_err, compare(torch, got, ref, label))
        counts = {s: structure_lanes(drawn[s], trace.n) for s in group}
        n_det = int((got.outcome == C.OUTCOME_DETECTED).sum())
        log(f"K1 vs plain {label}: {faults.kind.shape[0]} lanes equal, "
            f"{int(got.escaped.sum())} escaped, {int(got.overflow.sum())} "
            f"overflowed, {n_det} detected, sentinel/bubble lanes {counts} "
            f"({time.monotonic() - t0:.1f} s)")
        if ml and counts["latch"]["bubble"] == 0:
            fail("(e): no latch lane is a pipeline bubble")
        if not ml and (n_det == 0 or min(
                c["sentinel"] for c in counts.values()) == 0):
            fail("(e): no FU fault detected, or a structure drew no "
                 "wrong-path sentinel")
    del drawn, got, ref
    marks("4 K1 vs plain")

    # 5. the main path, counted
    taint_cuda.taint_fast_cuda.launches = 0
    t0 = time.monotonic()
    tally = kernel.run_keys(keys, "regfile")
    torch.cuda.synchronize()
    t_main = time.monotonic() - t0
    launches = taint_cuda.taint_fast_cuda.launches
    if launches < 1:
        fail("the main path never launched the fast-pass kernel")
    tally = tally.tolist()
    log(f"main path run_keys({N_KEYS}, 'regfile'): tally {tally}, "
        f"{kernel.escapes} escaped lanes resolved, {launches} kernel "
        f"launch(es), {t_main:.1f} s")
    if sum(tally) != N_KEYS:
        fail(f"tally sums to {sum(tally)}, not {N_KEYS}")
    pin = kernel.run_keys(keys[:N_PIN], "regfile").tolist()
    if pin != PIN_TALLY:
        fail(f"first {N_PIN} keys: tally {pin} != JAX reference "
             f"{PIN_TALLY}")
    log(f"first {N_PIN} keys: tally {pin} == JAX reference pin")
    sub = kernel.sample_batch(keys[:N_ORACLE], "regfile")
    oracle = kernel.oracle_outcomes(sub)
    hybrid = kernel.run_batch_hybrid(sub, may_latch=False)
    dense = kernel.run_batch(sub).cpu().numpy()
    for name, out in (("hybrid", hybrid), ("dense", dense)):
        bad = int((out != oracle).sum())
        if bad:
            fail(f"{name}: {bad}/{N_ORACLE} outcomes differ from the C++ "
                 f"oracle")
    log(f"{N_ORACLE} outcomes: hybrid and dense equal the C++ oracle")
    marks("5 main path")

    # 6. timings
    args, kw, got = flagship
    stream = kernel.packed_stream
    k1_ms = time_ms(torch, lambda: taint_fast_cuda(*args, **kw,
                                                   stream=stream))
    # phase 4 ran the plain version at this shape, and phase 5's run_keys
    # the row pass and the dense re-run: no warm-up run for these three
    plain_ms = time_ms(torch, lambda: taint_fast_plain(*args, **kw), 1,
                       warm=False)
    # record_golden: one timed call (phase 3 recorded this window)
    rec_ms = time_ms(torch, lambda: record_golden(
        kernel.tr, kernel.init_reg, kernel.init_mem, True, True), 1,
        warm=False)
    esc = got.escaped.cpu().numpy()
    ovf = got.overflow.cpu().numpy()
    row_idx = np.nonzero(esc & ~ovf)[0]
    dense_idx = np.nonzero(ovf)[0]
    row_lanes = flag_faults.index(torch.as_tensor(
        kernel._bucket(row_idx), device=dev))
    dense_lanes = flag_faults.index(torch.as_tensor(
        kernel._bucket(dense_idx if len(dense_idx) else row_idx[:1]),
        device=dev))
    row_ms = time_ms(torch, lambda: kernel.taint_batch(row_lanes, True),
                     REPS_HOST, warm=False)
    dense_ms = time_ms(torch, lambda: kernel.run_batch(dense_lanes),
                       REPS_HOST, warm=False)
    # run_keys: phase 5's counted main path, timed there
    e2e_ms = t_main * 1e3

    k = kw["k"]
    n, B = trace.n, N_KEYS
    bytes_moved = (16 * n * 4 + B * 8 * 4
                   + (trace.nphys + trace.mem_words) * 4
                   + B * 4 * 4 + 2 * k * B * 4)
    cyc = flag_faults.cycle.cpu().numpy()
    steps = got.steps.cpu().numpy()
    # K1's bound two ways: the full body on every step from each lane's
    # landing (as K2's is counted), and the function's own need
    # (need_operations), the kernels line's
    ops_landing = k1_operations(trace.opcode, cyc, steps, k, first=cyc)
    counts = torch.zeros((2, B), dtype=torch.int32, device=dev)
    taint_fast_cuda(*args, **kw, counts=counts, stream=stream)
    loud = (~taint_cuda.quiet_steps(args[0], args[1])).cpu().numpy()
    ops, full_steps, untouched = need_operations(
        trace.opcode, loud, cyc, steps, counts.cpu().numpy(), k)
    walk = int((got.steps.to(torch.int64) - taint_cuda.lane_starts(
        flag_faults, n)).max())
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_INT32_OPS_PER_S * 1e3
    log(f"K1 longest walk {walk} steps, {k1_ms * 1e6 / walk:.1f} ns per "
        f"step on it; bound {max(t_bytes, t_ops):.4f} ms ({full_steps} "
        f"full lane-steps; {untouched} untouched lane-steps walked, "
        f"{untouched * OPS_UNTOUCHED / H100_INT32_OPS_PER_S * 1e3:.4f} ms "
        f"of the design's own cost), "
        f"{ops_landing / H100_INT32_OPS_PER_S * 1e3:.4f} ms counting the "
        f"full body from each landing")
    timings = {
        "card": card, "k1_ms": k1_ms, "plain_ms": plain_ms,
        "record_golden_ms": rec_ms,
        "row_pass_ms": row_ms, "row_pass_lanes": int(row_lanes.kind.shape[0]),
        "row_pass_escapes": int(len(row_idx)),
        "dense_ms": dense_ms, "dense_lanes": int(dense_lanes.kind.shape[0]),
        "dense_overflows": int(len(dense_idx)),
        "run_keys_ms": e2e_ms, "trials_per_s": N_KEYS / (e2e_ms / 1e3),
        "bytes": bytes_moved, "ops": ops,
        "full_lane_steps": full_steps, "untouched_lane_steps": untouched,
        "untouched_ops": untouched * OPS_UNTOUCHED,
        "longest_walk": walk, "ns_per_step": k1_ms * 1e6 / walk,
        "bound_ms": max(t_bytes, t_ops),
        "ops_from_landing": ops_landing,
        "bound_from_landing_ms": ops_landing / H100_INT32_OPS_PER_S * 1e3}
    log(json.dumps({"timings": timings}))
    marks("6 timings")
    chunk_timings, k2_record = chunked_phases(torch, dev, marks)
    log(json.dumps({"timings": {"card": card, **chunk_timings}}))
    # phases 13 and 14 + 18 in their lanes, beside phases 11, 12 and 15
    t_lanes = time.monotonic()
    lanes_dir = start_lanes()
    paths = structure_phases(torch, dev, marks, kernel_s, keys, card)
    log(json.dumps({"timings": paths["timings"]}))
    del kernel_s
    mesh_run = mesh_phase(torch, marks, card)
    log(json.dumps({"timings": mesh_run["timings"]}))
    lanes = join_lanes(lanes_dir, t_lanes)
    cli_run, matrix_run = lanes["cli_phase"], lanes["matrix_phase"]
    log(json.dumps({"timings": cli_run["timings"]}))
    log(json.dumps({"timings": lanes["tier_phase"]}))
    log(json.dumps({"timings": matrix_run["timings"]}))
    log(f"phases 11-15 and 18 in three processes: "
        f"{time.monotonic() - t_lanes:.1f} s (lanes "
        + ", ".join(f"{n} {s:.1f} s" for n, s in lanes["lane_s"].items())
        + ")")
    t_mark[0] = time.monotonic()
    ingest_run = ingest_phase(torch, marks, card)
    log(json.dumps({"timings": ingest_run["timings"]}))
    ckpt_run = checkpoint_phase(torch, marks, card)
    log(json.dumps({"timings": ckpt_run["timings"]}))
    paths["launches"].update(cli_run["launches"])
    paths["launches"].update(mesh_run["launches"])
    paths["launches"].update(ingest_run["launches"])
    paths["launches"].update(ckpt_run["launches"])
    paths["launches"].update(matrix_run["launches"])
    # launches on each main path, each counted from 0 just before it
    k1_paths = {"run_keys regfile": launches, **{
        p: n for p, n in paths["launches"].items() if "chunked" not in p}}
    k2_paths = {"outcomes_from_keys regfile": k2_record["launches"], **{
        p: n for p, n in paths["launches"].items() if "chunked" in p}}
    max_err = max(max_err, paths["k1_max_err"], cli_run["k1_max_err"],
                  mesh_run["k1_max_err"], ingest_run["k1_max_err"],
                  ckpt_run["k1_max_err"], matrix_run["k1_max_err"])
    k2_err = max(k2_record["max_abs_err"], ingest_run["k2_max_err"])
    k2_record.update(launches=sum(k2_paths.values()),
                     launches_by_path=k2_paths, max_abs_err=float(k2_err),
                     matches_plain=k2_err == 0)
    record = {"kernels": [{
        "name": "taint_fast", "route": "cuda",
        "source": "shrewd_tpu_torch/csrc/taint_fast.cu",
        "replaces": "shrewd_tpu/ops/pallas_taint.py:513",
        "launches": sum(k1_paths.values()), "launches_by_path": k1_paths,
        "max_abs_err": float(max_err),
        "matches_plain": max_err == 0,
        "ms": k1_ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None}, k2_record]}
    log(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--lane":
        sys.exit(lane_main(sys.argv[2], sys.argv[3]))
    sys.exit(main())
