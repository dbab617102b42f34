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
    to (b)'s;
19. the federation on the card, K1's counts zeroed before each part and
    its batch-sized launch held bitwise against its plain version in
    each (the sweep's 96-µop launches of every lane count): (a)
    ``python -m shrewd_tpu_torch.tools.federation --plans`` in a child
    process (``python3 chip_smoke.py --fed-cli RESULT ARGS…``, which runs
    the module through ``runpy`` as ``python -m`` does, under K1's
    counters), 3 pods, three tenants of the flagship window at full
    width (regfile, fu, lsq, plan seeds 3, 5, 7, batch 2048, stratified,
    target 0.02, 4096-8192 trials, integrity at its defaults), the HTTP
    front on ``127.0.0.1``, a lease that expires after one silent round,
    ``kill_pod`` on pod2 at its tick 1 and ``partition_pod`` on pod0
    for 2 rounds: rc 0, both faults injected and survived, pod2 alone
    dead, failovers >= 1, fenced >= 1, one journaled ``done`` record per
    tenant, each tenant's tallies equal to a solo ``Orchestrator`` run of
    its plan on the card (run here meanwhile), every trial on the device
    tier with integrity clean, the card's allocated bytes around the
    kill printed, then ``--status`` rc 0; (b) the regfile plan run to 3
    batches as 3 stripes on 3 pods under ``kill_shard``: the merged
    tallies equal to the same plan unsharded on one pod, the busy-time
    ratio printed as a reading (the pods share one card); (c) the
    ``port10`` matrix through ``FederatedScenarioRunner`` on a 2-pod
    floor with an ``Autoscaler``: rc 0, the pool back at its floor, its
    scale-ups, retires and rounds printed, and its front (without the
    ``cells`` provenance) bitwise equal to phase 18's, compared in
    ``main`` once the lanes end; (d) ``run_gateway_crashcheck`` over
    ``small_fleet_plans(seeds=(3, 5))``, the two-phase placement's 4
    ``route``/``place`` points each with its torn tail: ``ok``, 0
    divergent recoveries;
20. certification on the card, in the ``cli`` lane after phase 13: (a)
    ``tools.graftlint --strict --audit-waivers --json --sarif`` over the
    port's tree with the step audit on the card: rc 0, every standard
    step's certificate ``ok`` at one transfer, both violation fixtures
    rejected, and beside each certificate the auditor's host-sync census
    equal to torch's ``set_sync_debug_mode("warn")`` count over the same
    call; (b) phase 13's plan at full width, ``--until-ci --certify
    strict``: rc 0, the results equal to ``PIN_CLI``, ``stats.json``
    (less the port's own ``perf`` fields) equal to phase 13's until-CI
    run's, nothing refused, K1 launches = the batches + 2 per canary run
    + the audit samples + the launches of the audited steps, K1 bitwise
    equal to its plain version on the first batch launch of each
    structure; (c) once the lanes end, ``tools.obs --summarize`` and
    ``--timeline`` over the trace phase 13's resumed run wrote and
    ``--tail`` over phase 18's and phase 19's ``metrics.json``: rc 0
    each;
21. the north-star sweep on the card at ``BENCH_r07.json``'s
    settings, at full width, cut to one of its two workloads for the
    script's time limit (``NS``: ``workloads/sort.c``, k=1, interval
    4000, all six O3 structures, ±0.008, at most 16384 trials, serial
    batch 4096, fleet batch 1024, ``sync_every`` 4, depth budget 4: 6
    campaigns an arm), in a lane of its own: (a)
    ``tools.northstar._build_windows``, each window's µops, macro-ops,
    lift rate and weight and the capture and emulate + lift seconds
    apart (its ptrace captures are the only ones while the lanes run);
    (b) the serial arm, ``_run_serial``, K1's count zeroed just before
    it: every campaign's trials a multiple of 4096 and at most 16384,
    converged or capped, one K1 launch per batch, K1 bitwise equal to
    its plain version on its first launch, each structure's weighted AVF
    the sum over its SimPoint rows, and the first batch of the regfile
    and the latch campaign (the ``MinorConfig`` path) equal, keys and
    tally, to the same batch on the CPU (a spawned process, run beside
    the card's arms); (c) the fleet arm, ``_run_fleet``, from a cold
    kernel registry, K1's count zeroed just before it: rc 0, every
    tenant complete, converged or capped, one K1 launch per dispatched
    batch (the engine drops intervals dispatched past a tenant's stop),
    K1 bitwise equal to its plain version, the regfile and latch tenants
    equal, tallies and trials, to a solo ``Orchestrator`` run of their
    plans on the card; the two arms' seconds and their ratio printed as
    a reading; (d) ``tools.simpoint_avf`` on ``intmm.c`` (k=1, 1024
    trials a window): each window's tally sums to 1024, 256 keys a
    window give the C++ oracle's outcomes, one K1 launch a window, K1
    bitwise equal to its plain version.  Both cuts (``intmm.c`` out of
    (b)-(c), (d) at k=1, not 3) were taken for the time limit.
22. the validation tools on the card, ``sort.c`` built with this
    machine's gcc; each tool's captures and host runs are taken once and
    shared by its card and CPU runs.  (a), (d) and (e), which capture or
    ptrace, run in the ``ns`` lane after phase 21; (b) and (c), ~100 s
    and ~20 s of step loops over the 6882-µop window, run in a child
    process of this script (``python3 chip_smoke.py --child validation
    RESULT LIFT``) beside phases 16-17 once the lanes end, on the window
    (a) lifted (they start no capture): (a) ``tools.timing_validate``: rc
    0, the macro-ops, µops, proxy cycles and both scoreboard cycle counts
    equal to a ``--platform cpu`` run, the rdtsc figures printed as a
    reading; (b) ``tools.timing_effect`` at its 8192 trials: K1's count
    zeroed just before it, exactly 12 launches (one a ``run_keys``: rob,
    iq, lsq and fu under the proxy, scoreboard and squash models), the
    first bitwise equal to its plain version, every tally summing to
    8192, and iq's first 1024 outcomes under each model equal to the
    CPU's; (c) ``tools.protect_validate`` at its 8192 trials: its rc the
    one its ``pass`` gives, no K1 launch (both kernels carry the memmap:
    every lane dense), the protected fu leg's first 1024 outcomes equal
    to the CPU's, ``pass`` printed (the CPU sides of (b) and (c) in a
    spawned process beside the card's runs); (d)
    ``tools.diff_artifacts --mode fp`` on ``fpmix.c`` at 8 trials: no
    row with ``error``, the summary present, every escalated trial
    classified by the emulator; (e) ``tools.threeway_diff`` against
    ``GEM5_GOLDEN_r04.json``: ``sort.c``'s sha256 printed beside the
    golden's; where they differ the tool refuses (``BinaryMismatch``, the
    reference's message, and rc 1 from ``python -m``) with no
    ``run_host``, capture or ``run_device`` call and no ptrace child
    started; where they are equal, on the golden trimmed to 64 trials,
    the document equal to the CPU run's;
23. ``tools.strat_effect`` on the card, in the ``fed`` lane after phase
    19, at batch 512 and 4 of its 24 batches (cut for the time limit):
    K1's count zeroed just before it, exactly 2 x 4 launches (one a batch
    of the O3 regfile and fu tiers), the first bitwise equal to its plain
    version, and each tier's first batch of stratified tallies (O3
    regfile and fu, MESI state, dir and tbe, the NoC router) equal to
    the same batch on the CPU (a spawned process beside the card's run).
24. ``tools.bigwindow`` on ``lzss.c`` (``WINDOW``) at the tool's two
    smaller lengths: (a) ``--build`` in the ``ns`` lane after phase 22,
    one capture cut at 50000 macro-steps, lifted at 4096 and 65536 µops
    into the tool's cache: the capture cut, each window at least its
    length; (b) and (c) in a child process beside phases 16-17
    (``--child window RESULT``; they start no capture), each count zeroed
    just before its run and printed after it: (b) the dense rate at 4096
    (batch 131072, the warm call and one timed): K1 two launches, one a
    ``run_keys``, the first bitwise equal to its plain version, no K2
    launch; (c) the chunked rate at 4096 and 65536, chunk 16384 (1 and 5
    chunks, batch 16384 each): K2 one launch a fast wave, the first wave
    of each chunk length bitwise equal to its plain version, no K1
    launch; the first 1024 keys of each run equal, lane for lane, to the
    port's run of the same window on the CPU (two spawned processes
    beside the card's runs), and the chunked outcomes on the 4096-µop
    window equal to the dense ones.

Batch (e) of phase 4 holds K1 against its plain version on the lanes the
structure path draws: 2048 each of fu, rob, iq, lsq and latch from the
port's own samplers, with wrong-path sentinels, pipeline bubbles and the
FU pool's coverage.

Phases 1-10 run alone in this process, so the kernels line's times
(phases 6, 9 and 10) are taken with nothing else on the card.  Phases 13
+ 20, 14 + 18, 19 + 23 and 21 + 22 + 24 (a) then run in four child
processes of this script, one lane each (``python3 chip_smoke.py --lane
NAME RESULT``: its own launch counters, each zeroed before its path as
here; the lane's output is printed when it ends and its results come back
as JSON),
beside this process's phases 11, 12 and 15.  Phases 16 and 17, which
trace binaries with ptrace, run after the lanes end, with phase 22 (b)
and (c) and phase 24 (b) and (c) (no capture) in two child processes
beside them; the captures of phases 21, 22 and 24, one after another in
one lane, are the only ones while the lanes run.  The seconds of phases
11-24 are readings taken beside one another.

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
# phase 19: the federation.  (a) three tenants of the flagship window at
# full width through the federation CLI on 3 pods; two batches a tenant
# (min_trials), so that the partitioned pod still runs a tenant when it
# heals and is fenced; the lease expires after one silent round
FED_TENANTS = (("regfile", 3), ("fu", 5), ("lsq", 7))
FED_PODS = 3
FED_MIN_TRIALS = 4096
FED_EXPIRY = 1
FED_CHAOS = {"faults": [
    {"kind": "kill_pod", "pod": "pod2", "at_tick": 1},
    {"kind": "partition_pod", "pod": "pod0", "at_round": 3, "rounds": 2}]}
# (b) one regfile campaign run to 3 batches, one stripe a pod
FED_SHARDS = 3
FED_SHARD_TRIALS = 3 * MATRIX_BATCH
FED_SHARD_CHAOS = {"faults": [
    {"kind": "kill_shard", "shard": "camp+shard1", "at_round": 2}]}
# (c) the port10 matrix on a 2-pod floor; (d) the gateway sweep's points
FED_AUTOSCALE = dict(min_pods=2, max_pods=3, up_trials=16384.0,
                     down_trials=2048.0, cooldown_rounds=1)
FED_SWEEP_POINTS = 4
# phase 21: the north-star sweep at BENCH_r07.json's settings, full width
# (tools.northstar's flags), one of its two workloads (intmm.c was cut for
# the time limit); the (workload, structure) campaigns held card = CPU on
# their first batch in (b) and fleet = solo in (c); (d) tools.simpoint_avf
# on intmm.c, its windows' first keys held against the C++ oracle.
# NS_DEVICE is where the phase runs: the card (a rehearsal on the CPU sets
# "cpu" and shrinks NS).
NS = dict(workloads=["workloads/sort.c"], k=1, interval=4000,
          halfwidth=0.008, max_trials=16384, batch=4096, fleet_batch=1024,
          sync_every=4, depth_budget=4, seed=0)
NS_HELD = (("workloads/sort.c", "regfile"), ("workloads/sort.c", "latch"))
NS_SA = dict(workload="workloads/intmm.c", k=1, trials=1024, oracle=256)
NS_DEVICE = "cuda"

# phase 22: the validation tools on sort.c at their defaults, (d)
# diff_artifacts in fp mode on fpmix.c at 8 trials (phase 16 (d) covers
# output and device64 on sort.c), (e) threeway_diff against the sort.c
# golden, trimmed to its first 64 trials where this machine's gcc builds
# gem5's binary.  (b) and (c) hold the first VAL["held"] keys of one
# structure card = CPU (the CPU walks the ~6900-µop window at ~80 s a
# model for 8192 keys).  Phase 23: strat_effect at batch 512, 4 of its 24
# batches (cut for the time limit).  NS_DEVICE is where both run.
VAL = dict(workload="workloads/sort.c", trials=8192, held=1024,
           structure="iq", fp_workload="workloads/fpmix.c", fp_trials=8,
           golden="GEM5_GOLDEN_r04.json", golden_trials=64)
STRAT = dict(batch=512, batches=4)
# phase 24: tools.bigwindow on lzss.c at the tool's two smaller lengths
# (524288 runs through the tool alone: its dense warm call took 205 s on
# an H100 80GB HBM3 at 700 W): (a) the build, one capture cut at
# max_steps (~34,600 macro-steps lift to 65546 µops on gcc 12.2's build),
# in the ns lane;
# (b) the dense rate at 4096 and (c) the chunked rate at both lengths,
# chunk 16384 (4096: 1 chunk; 65546: 5), at the tool's batches on the
# card, one timed call after the warm one, in a child process beside
# phases 16-17; the first `held` keys of each run held card = CPU.
# NS_DEVICE is where it runs.
WINDOW = dict(workload="workloads/lzss.c", lengths=(4096, 65536),
              max_steps=50000, dense=4096, chunk=16384, reps=1, held=1024)

LANES = {"cli": ("cli_phase", "certify_phase"),
         "tiers": ("tier_phase", "matrix_phase"),
         "fed": ("fed_phase", "strat_phase"),
         "ns": ("northstar_phase", "validation_phase",
                "window_build_phase")}
LANE_PHASES = {"cli": "13 and 20", "tiers": "14 and 18", "fed": "19 and 23",
               "ns": "21, 22 and 24 (a)"}
LANE_TIMEOUT_S = 900            # from the lanes' start to their last result
_lanes: list = []               # (name, Popen) of the lanes started
KEEP_DIR = None                 # in a lane: where phases leave artifacts
_PHASES: dict = {}              # in a lane: the results of its phases so far
# the perf fields of stats.json that hold wall-clock time or count the
# port's own machinery (phase 20 (b) compares the rest)
PERF_OWN = ("device_step_seconds", "device_wait_seconds", "host_seconds",
            "overlap_fraction", "host_roundtrips_saved",
            "executables_compiled", "executables_reused",
            "executables_certified", "executables_refused",
            "exec_cache_keys")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def keep(tag: str, paths) -> None:
    """In a lane: copy ``paths`` into ``KEEP_DIR/tag/`` for phase 20 (c),
    which runs in the parent once the lanes end."""
    import os
    import shutil

    if KEEP_DIR is None:
        return
    dest = os.path.join(KEEP_DIR, tag)
    os.makedirs(dest, exist_ok=True)
    for path in paths:
        shutil.copy(path, dest)


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
    # traced, for phase 20 (c): the tracer goes off again after it
    from shrewd_tpu_torch.obs import trace as obs_trace

    try:
        resumed = run("(c) resume", ["resume", ckpt_c, "--outdir",
                                     os.path.join(d, "c2"), "--trace"],
                      PIN_CLI, n0=3, mon0=_read_json(os.path.join(
                          ckpt_c, "campaign.json"))["integrity"])
    finally:
        obs_trace.disable()
    keep("13", [os.path.join(d, "c2", "trace.json")])
    until_stats = _read_json(os.path.join(d, "b2", "stats.json"))
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
    return {"timings": timings, "launches": launches, "k1_max_err": max_err,
            "until_stats": until_stats}


def certify_phase(torch, marks, card) -> dict:
    """Phase 20 (a) and (b), certification on the card, after phase 13 in
    its lane → the timings, K1's launches on each path and K1's largest
    difference from its plain version ((c) runs in ``main``)."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    from shrewd_tpu_torch import native
    from shrewd_tpu_torch.analysis import step_audit
    from shrewd_tpu_torch.campaign.plan import CampaignPlan, TraceFileSpec
    from shrewd_tpu_torch.main import main as cli
    from shrewd_tpu_torch.models.o3 import KIND_FU, KIND_REGFILE, O3Config
    from shrewd_tpu_torch.ops import taint_cuda, trial
    from shrewd_tpu_torch.ops.taint_cuda import taint_fast_cuda
    from shrewd_tpu_torch.parallel import exec_cache
    from shrewd_tpu_torch.tools import graftlint as graftlint_cli
    from shrewd_tpu_torch.trace import format as tf
    from shrewd_tpu_torch.utils.device import host_sync

    timings: dict = {"card": card}
    launches: dict = {}
    d = tempfile.mkdtemp(prefix="chip_smoke_certify_")
    t_phase = time.monotonic()

    # (a) the linter and the step audit on the card
    taint_fast_cuda.launches = 0
    lint_json = os.path.join(d, "lint.json")
    out = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = graftlint_cli.main(["--strict", "--audit-waivers", "--json",
                                 lint_json, "--sarif",
                                 os.path.join(d, "lint.sarif")])
    wall_a = time.monotonic() - t0
    if rc != 0:
        sys.stdout.write(out.getvalue())
        fail(f"20 (a): tools.graftlint rc {rc}")
    doc = _read_json(lint_json)
    ex = doc["executables"]
    if doc["violations"] or doc["stale_waivers"] or not ex["ok"]:
        fail(f"20 (a): lint {doc['violations']} stale "
             f"{doc['stale_waivers']} executables ok {ex['ok']}")
    if not (ex["fixture_rejected"] and ex["until_ci_fixture_rejected"]):
        fail("20 (a): a violation fixture was certified on the card")
    census = {}
    for name, cert in [*ex["certificates"].items(),
                       ("fixture/broken-interval", ex["violation_fixture"]),
                       ("fixture/broken-until-ci",
                        ex["until_ci_violation_fixture"])]:
        ours = sum(cert["syncs"].values())
        census[name] = {"syncs": cert["syncs"], "total": ours,
                        "torch": cert["sync_debug"],
                        "transfers": cert["transfers"]}
        if ours != cert["sync_debug"]:
            fail(f"20 (a) {name}: the auditor counted {ours} host syncs "
                 f"{cert['syncs']}, torch's sync debug mode "
                 f"{cert['sync_debug']}")
        if not name.startswith("fixture") and (
                not cert["ok"] or cert["transfers"] != 1):
            fail(f"20 (a) {name}: {cert['violations']}")
    launches["certify (a) standard steps"] = taint_fast_cuda.launches
    timings["certify_a"] = {"wall_s": wall_a, "census": census,
                            "waivers": len(doc["waivers"])}
    log(f"20 (a): tools.graftlint rc 0, 0 violations, {len(doc['waivers'])}"
        f" reasoned waivers, 0 stale; {len(ex['certificates'])} "
        "certificates ok at 1 transfer on the card, both fixtures "
        f"rejected; the sync census == torch's count on each of "
        f"{len(census)} calls ("
        + ", ".join(f"{n} {c['total']}" for n, c in census.items())
        + f"); K1 {taint_fast_cuda.launches} launches; {wall_a:.1f} s "
        f"({card})")
    marks("20 (a) graftlint on the card")

    # (b) phase 13's plan, until-CI, certified strict
    until_stats = _PHASES.get("cli_phase", {}).get("until_stats")
    if until_stats is None:
        fail("20 (b): phase 13's until-CI stats.json is missing")
    trace = native.generate_trace(**FLAGSHIP)
    npz = os.path.join(d, "flagship.npz")
    tf.save(npz, trace, meta={"source": "native.generate_trace",
                              **FLAGSHIP})
    plan = CampaignPlan(
        simpoints=[TraceFileSpec(name="flagship", path=npz)],
        structures=["regfile", "fu"], batch_size=CI_BATCH,
        target_halfwidth=CLI_TARGET, stratify=True,
        machine=O3Config(shadow_model="fupool"))
    plan_path = os.path.join(d, "plan.json")
    plan.dump_json(plan_path)
    sizes: list = []
    kept: dict = {}
    audit_sizes: list = []
    launch = trial.taint_fast_cuda

    def sized(*a, **kw):
        got = launch(*a, **kw)
        n = int(a[3].kind.shape[0])
        sizes.append(n)
        # this probe's own host read, inside the audited steps too: marked
        # as designed, so the strict auditor judges the program alone
        with host_sync("chip_smoke probe"):
            kind = int(a[3].kind[0])
        if n == CI_BATCH and kind not in kept:
            kept[kind] = (a, {x: v for x, v in kw.items() if x != "stream"},
                          got)
        return got

    audit_call = step_audit.StepAuditor.__call__
    audit_s = [0.0]

    def timed_audit(self, fn, args, key):
        n0, t = len(sizes), time.monotonic()
        try:
            return audit_call(self, fn, args, key)
        finally:
            audit_s[0] += time.monotonic() - t
            audit_sizes.extend(sizes[n0:])

    trial.taint_fast_cuda = sized
    step_audit.StepAuditor.__call__ = timed_audit
    taint_fast_cuda.launches = 0
    outdir = os.path.join(d, "b")
    t0 = time.monotonic()
    try:
        rc = cli(["run", plan_path, "--outdir", outdir, "--until-ci",
                  "--certify", "strict"])
        torch.cuda.synchronize()
    finally:
        trial.taint_fast_cuda = launch
        step_audit.StepAuditor.__call__ = audit_call
        auditor = exec_cache.current_auditor()
        exec_cache.clear_auditor()
    wall_b = time.monotonic() - t0
    if rc != 0:
        fail(f"20 (b): CLI rc {rc}")
    ckpt = _read_json(os.path.join(outdir, "campaign_ckpt",
                                   "campaign.json"))
    stats = _read_json(os.path.join(outdir, "stats.json"))
    batches = 0
    for s, pin in PIN_CLI.items():
        st = ckpt["state"]["flagship"][s]
        got = dict(tallies=st["tallies"], trials=sum(st["tallies"]),
                   batches=st["next_batch"], strata=st["strata"])
        if got != pin or not st["converged"]:
            fail(f"20 (b) {s}: {got} != JAX reference {pin}")
        batches += pin["batches"]
    perf = stats["perf"]
    if perf["executables_refused"] or not perf["executables_certified"]:
        fail(f"20 (b): {perf['executables_refused']} steps refused, "
             f"{perf['executables_certified']} certified")
    if auditor is None or not auditor.strict or auditor.failed:
        fail("20 (b): the strict auditor was not installed or failed a "
             "step")
    same = {}
    for tag, doc_s in (("strict", stats), ("phase 13", until_stats)):
        doc_s = json.loads(json.dumps(doc_s))
        for k in PERF_OWN:
            doc_s["perf"].pop(k)
        same[tag] = doc_s
    if same["strict"] != same["phase 13"]:
        diff = sorted(k for k in same["strict"]
                      if same["strict"][k] != same["phase 13"].get(k))
        fail(f"20 (b): stats.json differs from phase 13's until-CI run "
             f"in {diff}")
    ig = ckpt["integrity"]
    want = {CI_BATCH: batches, 3: ig["canary_runs"], 2: ig["canary_runs"],
            64: ig["audit_batches"]}
    for n in audit_sizes:
        want[n] = want.get(n, 0) + 1
    got = {n: sizes.count(n) for n in set(sizes) | set(want)}
    if got != want or taint_fast_cuda.launches != len(sizes):
        fail(f"20 (b): K1 launches by lane count {got} != the batches, "
             f"canaries, audit samples and audited steps {want} (counter "
             f"{taint_fast_cuda.launches})")
    if audit_sizes.count(CI_BATCH) < 1:
        fail("20 (b): no audited step launched K1 on a batch")
    max_err = 0
    for kind, name in ((KIND_REGFILE, "regfile"), (KIND_FU, "fu")):
        if kind not in kept:
            fail(f"20 (b): no {CI_BATCH}-lane K1 launch of {name} was kept")
        args, kw, res = kept[kind]
        max_err = max(max_err, compare(
            torch, res, taint_cuda.taint_fast_plain(*args, **kw),
            f"20 (b) {name} batch"))
    launches["certify (b) strict until-CI CLI"] = len(sizes)
    timings["certify_b"] = {
        "wall_s": wall_b, "batches": batches,
        "trials_per_s": batches * CI_BATCH / wall_b,
        "audit_s": audit_s[0], "audited": auditor.audited,
        "certified": perf["executables_certified"],
        "k1_launches": len(sizes), "k1_audit_launches": len(audit_sizes),
        "canary_runs": ig["canary_runs"],
        "audit_batches": ig["audit_batches"],
        "phase13_until_wall_s": _PHASES["cli_phase"]["timings"][
            "cli_(b)_until-CI"]["wall_s"]}
    log(f"20 (b): --until-ci --certify strict rc 0, results == JAX pins, "
        f"stats.json == phase 13's until-CI run's but for the port's own "
        f"perf fields, {auditor.audited} steps audited, "
        f"{perf['executables_certified']} certified, 0 refused; K1 "
        f"{len(sizes)} launches = {batches} batches + 2 x "
        f"{ig['canary_runs']} canary runs + {ig['audit_batches']} audit "
        f"samples + {len(audit_sizes)} in the audited steps, == plain on "
        f"the regfile and fu batch launches; {wall_b:.1f} s, of which "
        f"{audit_s[0]:.1f} s auditing (phase 13's until-CI run "
        f"{timings['certify_b']['phase13_until_wall_s']:.1f} s) ({card})")
    shutil.rmtree(d, ignore_errors=True)
    timings["certify_phase_s"] = time.monotonic() - t_phase
    marks("20 (b) certified CLI")
    return {"timings": timings, "launches": launches, "k1_max_err": max_err}


def obs_phase(keep_dir: str, card) -> dict:
    """Phase 20 (c), in ``main`` once the lanes end: ``tools.obs`` over
    the artifacts phases 13, 18 and 19 left → the timings."""
    import contextlib
    import io
    import os

    from shrewd_tpu_torch.tools import obs as obs_cli

    t0 = time.monotonic()
    trace_json = os.path.join(keep_dir, "13", "trace.json")
    runs = {"summarize 13": ["--summarize", trace_json],
            "timeline 13": ["--timeline", trace_json],
            "tail 18": ["--tail", os.path.join(keep_dir, "18")],
            "tail 19": ["--tail", os.path.join(keep_dir, "19")]}
    lines = {}
    for tag, argv in runs.items():
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = obs_cli.main(argv)
        if rc != 0 or not out.getvalue().strip():
            fail(f"20 (c) tools.obs {' '.join(argv)}: rc {rc} "
                 f"{err.getvalue()[-300:]}")
        lines[tag] = len(out.getvalue().splitlines())
    wall = time.monotonic() - t0
    log(f"20 (c): tools.obs --summarize / --timeline over phase 13's "
        f"trace, --tail over phase 18's and 19's metrics.json: rc 0 each "
        f"({', '.join(f'{k} {n} lines' for k, n in lines.items())}); "
        f"{wall:.1f} s ({card})")
    return {"wall_s": wall, "lines": lines}


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
    probe = K1Probe(torch)
    sizes, kept, plain = probe.sizes, probe.kept, probe.plain
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
    probe.reset()
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
    probe.reset()
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
    if probe.plain_cuda:
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
    probe.close()
    keep("18", [os.path.join(outdir, "metrics.json")])
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
    return {"timings": timings, "launches": launches, "k1_max_err": max_err,
            "front": pareto_front(before)}


def pareto_front(art: dict) -> dict:
    """A ``PARETO_<tag>.json``'s design search without each group's
    ``cells`` key: which scheme-mate supplied a profile is provenance that
    may differ between schedules, everything the front decides on may
    not."""
    return {g: {k: v for k, v in r.items() if k != "cells"}
            for g, r in art["search"].items()}


def fed_plan(structure: str, seed: int, **kw) -> dict:
    """A phase 19 tenant's plan: the flagship window at full width, batch
    2048, stratified, target 0.02, at most 8192 trials, integrity at its
    defaults."""
    from shrewd_tpu_torch.campaign.plan import CampaignPlan

    doc = {"simpoints": [{"type": "WorkloadSpec", "name": "flagship",
                          "workload": dict(FLAGSHIP)}],
           "structures": [structure], "seed": seed,
           "batch_size": MATRIX_BATCH, "stratify": True,
           "target_halfwidth": MATRIX_TARGET,
           "max_trials": MATRIX_MAX_TRIALS, **kw}
    return CampaignPlan.from_dict(doc).to_dict()


class K1Probe:
    """K1's instrumentation in phases 18, 19 and 21: every launch's lane
    count, the first launch of each lane count kept for the comparison
    with the plain version, and calls of the plain version on card
    tensors.  ``reset`` zeroes the counts before a path."""

    def __init__(self, torch):
        from shrewd_tpu_torch.ops import taint_cuda, trial

        self.torch = torch
        self.trial, self.taint_cuda = trial, taint_cuda
        self.launch = trial.taint_fast_cuda
        self.plain = taint_cuda.taint_fast_plain
        self.sizes: list = []
        self.kept: dict = {}
        self.plain_cuda = 0

        def sized(*a, **kw):
            got = self.launch(*a, **kw)
            n = int(a[3].kind.shape[0])
            self.sizes.append(n)
            if n not in self.kept:
                self.kept[n] = (a, {x: v for x, v in kw.items()
                                    if x != "stream"}, got)
            return got

        def counted_plain(*a, **kw):
            if a[3].kind.device.type == "cuda":
                self.plain_cuda += 1
            return self.plain(*a, **kw)

        trial.taint_fast_cuda = sized
        taint_cuda.taint_fast_plain = counted_plain

    def reset(self) -> None:
        self.sizes.clear()
        self.kept.clear()
        self.plain_cuda = 0
        self.taint_cuda.taint_fast_cuda.launches = 0

    def read(self, what: str, only=None) -> tuple[int, int]:
        """→ (launches since ``reset``, the largest difference of the
        first launch of each lane count (of those in ``only``, when
        given) from its plain version); fails on no launch, a count that
        is not the lane counts', or a plain call on card tensors.  The
        plain version walks every step of the window whatever its lane
        count, ~5 s on the flagship window, so the flagship paths hold
        their batch-sized launch against it, as phase 18 does."""
        self.torch.cuda.synchronize()
        n = self.taint_cuda.taint_fast_cuda.launches
        if not n or n != len(self.sizes):
            fail(f"{what}: K1 counter {n}, launches seen {len(self.sizes)}")
        if self.plain_cuda:
            fail(f"{what}: K1's plain version ran on card tensors")
        err = 0
        for size, (a, kw, got) in sorted(self.kept.items()):
            if only is not None and size not in only:
                continue
            err = max(err, compare(self.torch, got, self.plain(*a, **kw),
                                   f"{what} {size}-lane launch"))
        return n, err

    def close(self) -> None:
        self.trial.taint_fast_cuda = self.launch
        self.taint_cuda.taint_fast_plain = self.plain


class KillMemory:
    """``PodHandle.kill`` wrapped: the card's allocated bytes before each
    kill and after it (and a collection) — a dead pod drops its
    scheduler; the kernels it shared stay with the registry."""

    def __init__(self, torch):
        import gc

        from shrewd_tpu_torch.federation import pods

        self.pods, self.kill, self.seen = pods, pods.PodHandle.kill, []
        kill = self.kill

        def counted(pod):
            before = torch.cuda.memory_allocated()
            kill(pod)
            gc.collect()
            self.seen.append([pod.name, before,
                              torch.cuda.memory_allocated()])

        pods.PodHandle.kill = counted

    def close(self) -> None:
        self.pods.PodHandle.kill = self.kill


def tenant_tiers(root: str, what: str) -> None:
    """Every tenant namespace of every pod under ``root`` ran all its
    trials on the device tier, with integrity clean."""
    import os

    seen = 0
    for dirpath, _dirs, files in os.walk(root):
        if "stats.json" not in files or \
                os.path.basename(os.path.dirname(dirpath)) != "tenants":
            continue
        stats = _read_json(os.path.join(dirpath, "stats.json"))
        tiers = stats["resilience"]["tier_trials"]
        ig = stats["integrity"]
        bad = {k: ig[k] for k in ("canary_failures", "invariant_violations",
                                  "audit_mismatches", "quarantined_batches")
               if ig[k]}
        if tiers["cpu"] or tiers["oracle"] or bad:
            fail(f"{what} {dirpath}: tier trials {tiers}, integrity {bad}")
        seen += 1
    if not seen:
        fail(f"{what}: no tenant stats under {root}")


def fed_cli_main(result: str, argv: list) -> int:
    """``--fed-cli RESULT ARGS…``: phase 19 (a)'s child process.  It runs
    ``shrewd_tpu_torch.tools.federation`` as ``python -m`` runs it
    (``runpy``, as ``__main__``, with ARGS) under K1's instrumentation,
    and writes the launches, K1 against its plain version, the chaos
    ledger, the counters, each tenant's tallies and the kills' card
    memory to RESULT."""
    import os
    import runpy

    import torch

    from shrewd_tpu_torch import native
    from shrewd_tpu_torch.federation import driver
    from shrewd_tpu_torch.ops import taint_cuda
    from shrewd_tpu_torch.service import journal

    taint_cuda.build()
    native.build()
    feds: list = []
    init = driver.Federation.__init__

    def kept_init(self, *a, **kw):
        init(self, *a, **kw)
        feds.append(self)

    driver.Federation.__init__ = kept_init
    # the gateway's records, read at each append (compaction truncates)
    done: list = []
    append = journal.FleetJournal.append
    tail = os.path.join("gateway_ckpt", "journal.jsonl")

    def kept_append(self, kind, data=None):
        if kind == "done" and self.path.endswith(tail):
            done.append((data or {}).get("tenant"))
        return append(self, kind, data)

    journal.FleetJournal.append = kept_append
    probe = K1Probe(torch)
    mem = KillMemory(torch)
    probe.reset()
    sys.argv = ["shrewd_tpu_torch.tools.federation", *argv]
    rc = 0
    try:
        runpy.run_module("shrewd_tpu_torch.tools.federation",
                         run_name="__main__", alter_sys=True)
    except SystemExit as e:
        rc = e.code
    if rc != 0 or not feds:
        fail(f"(a) the federation CLI exited rc {rc}")
    n, err = probe.read("(a) federation CLI", only=(MATRIX_BATCH,))
    fed = feds[-1]
    names = sorted(fed.gateway.entries)
    doc = {"rc": rc, "launches": n, "k1_max_err": err,
           "sizes": sorted(set(probe.sizes)),
           "counters": fed.counters(),
           "injected": fed.chaos.injected, "survived": fed.chaos.survived,
           "entries": {nm: {"status": e.status, "pod": e.pod,
                            "epoch": e.epoch,
                            "path": [h["pod"] for h in e.history]}
                       for nm, e in fed.gateway.entries.items()},
           "tallies": {nm: {k: r["tallies"] for k, r in
                            ((fed.gateway.entries[nm].result or {})
                             .get("results") or {}).items()}
                       for nm in names},
           "done_records": {nm: done.count(nm) for nm in names},
           "kills": mem.seen}
    tmp = f"{result}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, result)
    return 0


def fed_phase(torch, marks, card) -> dict:
    """Phase 19, the federation on the card → the timings, K1's launches
    on each path, K1's largest difference from its plain version and the
    federated matrix's front (``main`` holds it against phase 18's)."""
    import os
    import shutil
    import tempfile

    from shrewd_tpu_torch.analysis import crashcheck
    from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
    from shrewd_tpu_torch.campaign.plan import CampaignPlan
    from shrewd_tpu_torch.chaos import ChaosEngine
    from shrewd_tpu_torch.federation import Autoscaler, Federation
    from shrewd_tpu_torch.scenario import (FederatedScenarioRunner,
                                           ScenarioMatrix)
    from shrewd_tpu_torch.service import TenantSpec
    from shrewd_tpu_torch.tools import federation as federation_cli

    timings: dict = {"card": card}
    launches: dict = {}
    max_err = 0
    t_phase = time.monotonic()
    d = tempfile.mkdtemp(prefix="chip_smoke_fed_")

    # (a) the CLI's direct mode in a child process; the solo runs of the
    # three plans here meanwhile
    paths, plans = [], {}
    for structure, seed in FED_TENANTS:
        plans[structure] = fed_plan(structure, seed,
                                    min_trials=FED_MIN_TRIALS)
        paths.append(os.path.join(d, f"{structure}.json"))
        with open(paths[-1], "w") as f:
            json.dump(plans[structure], f)
    chaos_path = os.path.join(d, "chaos.json")
    with open(chaos_path, "w") as f:
        json.dump(FED_CHAOS, f)
    root = os.path.join(d, "cli")
    result = os.path.join(d, "cli.json")
    argv = ["--plans", *paths, "--outdir", root, "--pods", str(FED_PODS),
            "--expiry-rounds", str(FED_EXPIRY), "--chaos-plan", chaos_path,
            "--http", "0"]
    t0 = time.monotonic()
    with open(result + ".out", "w") as out, \
            open(result + ".err", "w") as err:
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--fed-cli",
             result, *argv], stdout=out, stderr=err)
    solo: dict = {}
    solo_s: dict = {}
    for structure, plan in plans.items():
        t1 = time.monotonic()
        orch = Orchestrator(CampaignPlan.from_dict(plan))
        list(orch.events())
        solo_s[structure] = time.monotonic() - t1
        solo[structure] = {f"{sp}/{st}": r.tallies.tolist()
                           for (sp, st), r in orch.results.items()}
    rc = child.wait(timeout=LANE_TIMEOUT_S)
    wall_a = time.monotonic() - t0
    with open(result + ".err") as f:
        report = [ln for ln in f.read().splitlines()
                  if ln.startswith(("  t", "federation:", "admitted"))]
    if rc != 0:
        with open(result + ".err") as f:
            fail(f"(a) the federation CLI's process exited rc {rc}: "
                 f"{f.read()[-3000:]}")
    a = _read_json(result)
    cnt = a["counters"]
    want = {"kill_pod": 1, "partition_pod": 1}
    if a["injected"] != want or a["survived"] != want:
        fail(f"(a) chaos injected {a['injected']}, survived "
             f"{a['survived']}, not {want}")
    if cnt["dead_pods"] != ["pod2"] or cnt["failovers"] < 1 or \
            cnt["fenced"] < 1:
        fail(f"(a) counters {cnt}: want pod2 alone dead, failovers >= 1, "
             "fenced >= 1")
    names = {f"t{i}_{s}": s for i, (s, _) in enumerate(FED_TENANTS)}
    if sorted(a["entries"]) != sorted(names) or any(
            e["status"] != "done" for e in a["entries"].values()):
        fail(f"(a) ledger {a['entries']}")
    if any(v != 1 for v in a["done_records"].values()):
        fail(f"(a) the gateway journaled {a['done_records']} done records "
             "by tenant: each tenant is counted once")
    for name, structure in names.items():
        if a["tallies"][name] != solo[structure]:
            fail(f"(a) {name}: {a['tallies'][name]} != its solo run "
                 f"{solo[structure]}")
    tenant_tiers(root, "(a)")
    status = json.loads(_cli_stdout(federation_cli.main,
                                    ["--status", root]))
    if sorted(status["tenants"]) != sorted(names) or \
            status["dead_pods"] != ["pod2"]:
        fail(f"(a) --status: {status}")
    max_err = max(max_err, a["k1_max_err"])
    launches["federation CLI (a)"] = a["launches"]
    log("(a) " + "; ".join(report))
    log(f"(a) federation CLI, {FED_PODS} pods x {len(names)} tenants "
        f"under kill_pod + partition_pod: rc 0, failovers "
        f"{cnt['failovers']}, fenced {cnt['fenced']}, rounds "
        f"{cnt['rounds']}; each tenant counted once (one journaled done "
        f"record; paths {dict((n, e['path']) for n, e in a['entries'].items())}"
        f"), == its solo "
        f"run on the card; every trial on the device tier; K1 "
        f"{a['launches']} launches (lane counts {a['sizes']}), == plain on "
        f"the first batch; card memory allocated before/after the kill "
        f"{a['kills']}; --status rc 0; wall {wall_a:.1f} s (solo runs "
        f"{', '.join(f'{k} {v:.1f} s' for k, v in solo_s.items())}, beside "
        f"it) ({card})")
    timings["cli"] = {"wall_s": wall_a, "counters": cnt,
                      "k1_launches": a["launches"], "solo_s": solo_s,
                      "kills": a["kills"]}
    marks("19 (a) federation CLI")

    probe = K1Probe(torch)
    mem = KillMemory(torch)
    try:
        # (b) a sharded campaign: the unsharded run on one pod first (the
        # solo tallies and busy seconds), then 3 stripes on 3 pods
        plan = fed_plan("regfile", 3, min_trials=FED_SHARD_TRIALS,
                        max_trials=FED_SHARD_TRIALS)
        one = Federation(os.path.join(d, "solo"), pod_names=("solo0",))
        one.submit(TenantSpec(name="camp", plan=plan))
        if one.serve() != 0:
            fail("(b) the unsharded run did not converge")
        unsharded = {k: v.tolist() for k, v in
                     one.tenant_tallies("camp").items()}
        solo_busy = one.pods["solo0"].busy_s
        del one
        probe.reset()
        chaos = ChaosEngine(FED_SHARD_CHAOS)
        t0 = time.monotonic()
        fed = Federation(os.path.join(d, "sharded"),
                         pod_names=tuple(f"pod{i}" for i in range(FED_PODS)),
                         chaos=chaos, expiry_rounds=FED_EXPIRY)
        adm = fed.submit(TenantSpec(name="camp", plan=plan,
                                    shards=FED_SHARDS))
        if fed.serve() != 0:
            fail("(b) the sharded federation did not converge")
        wall_b = time.monotonic() - t0
        n_b, err_b = probe.read("(b) sharded campaign",
                                only=(MATRIX_BATCH,))
        e = fed.gateway.entries["camp"]
        merged = {k: v.tolist() for k, v in
                  fed.tenant_tallies("camp").items()}
        if chaos.injected != {"kill_shard": 1} or \
                chaos.survived != chaos.injected:
            fail(f"(b) chaos {chaos.injected} / {chaos.survived}")
        if merged != unsharded or e.result["status"] != "complete":
            fail(f"(b) merged {merged} ({e.result['status']}) != the "
                 f"unsharded run {unsharded}")
        if len(fed.gateway.dead_pods) != 1 or fed.failovers < 1:
            fail(f"(b) dead pods {fed.gateway.dead_pods}, failovers "
                 f"{fed.failovers}")
        tenant_tiers(os.path.join(d, "sharded"), "(b)")
        busy = fed.counters()["busy_s"]
        ratio = solo_busy / max(busy.values())
        max_err = max(max_err, err_b)
        launches["federation sharded (b)"] = n_b
        log(f"(b) {adm['shards']} over {FED_PODS} pods under kill_shard: "
            f"merged tallies == the unsharded run bitwise, {e.result['folds']}"
            f" folds, failovers {fed.failovers}; K1 {n_b} launches, == plain "
            f"on the first batch; busy s per pod {busy}, the "
            f"unsharded pod {solo_busy:.2f} s: a ratio of {ratio:.2f} "
            f"(a reading: the pods share one card); card memory before/after "
            f"the kill {mem.seen}; wall {wall_b:.1f} s ({card})")
        timings["sharded"] = {"wall_s": wall_b, "busy_s": busy,
                              "unsharded_busy_s": solo_busy,
                              "busy_ratio": ratio, "k1_launches": n_b,
                              "folds": e.result["folds"],
                              "kills": list(mem.seen)}
        del fed
        marks("19 (b) sharded campaign")

        # (c) the port10 matrix through a federation of pods
        probe.reset()
        t0 = time.monotonic()
        runner = FederatedScenarioRunner(
            ScenarioMatrix.from_dict(matrix_doc()), os.path.join(d, "matrix"),
            pod_names=("pod0", "pod1"), pareto_every=1,
            autoscale=Autoscaler(**FED_AUTOSCALE))
        if runner.serve() != 0:
            fail("(c) the federated matrix did not converge")
        wall_c = time.monotonic() - t0
        n_c, err_c = probe.read("(c) federated matrix",
                                only=(MATRIX_BATCH,))
        gw = runner.fed.gateway
        if sorted(gw.pods) != ["pod0", "pod1"] or gw.retiring or \
                runner.fed.retired != runner.fed.scale_ups:
            fail(f"(c) the pool did not return to its floor: {gw.pods}, "
                 f"{runner.fed.scale_ups} up, {runner.fed.retired} retired")
        art = _read_json(os.path.join(d, "matrix",
                                      f"PARETO_{MATRIX_TAG}.json"))
        tenant_tiers(os.path.join(d, "matrix"), "(c)")
        max_err = max(max_err, err_c)
        launches["federation matrix O3 cells (c)"] = n_c
        front = pareto_front(art)
        decisions = runner.decisions(runner.fed)
        log(f"(c) FederatedScenarioRunner {MATRIX_TAG!r} on 2 pods + an "
            f"autoscaler: rc 0, {runner.fed.scale_ups} scale-ups, "
            f"{runner.fed.retired} retires, {runner.fed.round} rounds, "
            f"{len(decisions)} cells pruned; K1 {n_c} launches, == plain on "
            f"the first batch; wall {wall_c:.1f} s ({card})")
        timings["matrix"] = {"wall_s": wall_c, "k1_launches": n_c,
                             "scale_ups": runner.fed.scale_ups,
                             "retired": runner.fed.retired,
                             "rounds": runner.fed.round,
                             "pruned": sorted(decisions)}
        del runner
        marks("19 (c) federated matrix")

        # (d) a bounded gateway sweep on the card: the two-phase
        # placement's route and place appends, each with its torn tail
        probe.reset()
        t0 = time.monotonic()
        sweep = crashcheck.run_gateway_crashcheck(
            os.path.join(d, "sweep"),
            crashcheck.small_fleet_plans(seeds=(3, 5)),
            max_points=FED_SWEEP_POINTS,
            point_filter=lambda pt: pt.kind in ("route", "place"))
        wall_d = time.monotonic() - t0
        n_d, err_d = probe.read("(d) gateway sweep")
        if not sweep["ok"] or sweep["failures"] or \
                sweep["points_checked"] != FED_SWEEP_POINTS:
            fail(f"(d) gateway sweep: ok {sweep['ok']}, "
                 f"{sweep['points_checked']} points checked, failures "
                 f"{sweep['failures'][:2]}")
        max_err = max(max_err, err_d)
        launches["federation crashcheck (d)"] = n_d
        log(f"(d) run_gateway_crashcheck: ok, {sweep['points']} boundaries, "
            f"{sweep['points_checked']} route/place points checked in "
            f"{sweep['checks']} recoveries ({sweep['torn_checks']} torn), 0 "
            f"divergent; K1 {n_d} launches, == plain on the first of each "
            f"lane count; wall {wall_d:.1f} s ({card})")
        timings["sweep"] = {"wall_s": wall_d, "points": sweep["points"],
                            "checks": sweep["checks"], "k1_launches": n_d}
        marks("19 (d) gateway sweep")
    finally:
        probe.close()
        mem.close()
    import glob

    keep("19", sorted(glob.glob(os.path.join(root, "**", "metrics.json"),
                                recursive=True))[:1])
    shutil.rmtree(d, ignore_errors=True)
    timings["fed_phase_s"] = time.monotonic() - t_phase
    return {"timings": timings, "launches": launches, "k1_max_err": max_err,
            "front": front}


def ns_cpu_tally(npz: str, structure: str, keys) -> list:
    """Phase 21 (b)'s CPU side, in a spawned process of its own (one torch
    thread), beside the card's arms: the first batch of a serial campaign
    on the window saved at ``npz``, run on the CPU → its tally."""
    import os

    import torch

    from shrewd_tpu_torch.models.minor import MinorConfig
    from shrewd_tpu_torch.models.o3 import O3Config
    from shrewd_tpu_torch.ops.trial import TrialKernel
    from shrewd_tpu_torch.parallel.campaign import ShardedCampaign
    from shrewd_tpu_torch.parallel.mesh import make_mesh
    from shrewd_tpu_torch.trace import format as tf

    # below the lanes' processes, which drive the card: this check only
    # has to be done by the end of (c)
    os.nice(10)
    torch.set_num_threads(1)
    trace, _ = tf.load(npz)
    kernel = TrialKernel(trace, O3Config(), MinorConfig(), device="cpu")
    camp = ShardedCampaign(kernel, make_mesh(["cpu"]), structure)
    return camp.tally_batch(torch.as_tensor(keys)).tolist()


def northstar_phase(torch, marks, card) -> dict:
    """Phase 21, the north-star sweep on the card → the timings, K1's
    launches on each arm and K1's largest difference from its plain
    version.  (a) the SimPoint windows of ``NS``'s workloads; (b)
    ``tools.northstar``'s serial arm; (c) its fleet arm; (d)
    ``tools.simpoint_avf`` on ``NS_SA``'s workload.  Every gate holds the
    card against the port on the CPU, a solo run, the C++ oracle or the
    kernel's plain version, never against a number pinned elsewhere: the
    workloads are built with this machine's gcc."""
    import argparse
    import concurrent.futures as cf
    import multiprocessing
    import os
    import shutil
    import tempfile

    from shrewd_tpu_torch.campaign.orchestrator import Orchestrator
    from shrewd_tpu_torch.campaign.plan import CampaignPlan
    from shrewd_tpu_torch.ingest import hostdiff as hd
    from shrewd_tpu_torch.ingest import simpoint as simpoint_mod
    from shrewd_tpu_torch.models.o3 import O3Config
    from shrewd_tpu_torch.ops.trial import TrialKernel
    from shrewd_tpu_torch.parallel import campaign as campaign_mod
    from shrewd_tpu_torch.parallel import exec_cache
    from shrewd_tpu_torch.service import scheduler as sched_mod
    from shrewd_tpu_torch.tools import northstar as ns
    from shrewd_tpu_torch.tools import simpoint_avf
    from shrewd_tpu_torch.utils import prng

    t_phase = time.monotonic()
    timings: dict = {"card": card}
    launches: dict = {}
    d = tempfile.mkdtemp(prefix="chip_smoke_ns_")
    platform = "cpu" if NS_DEVICE == "cpu" else None
    a = argparse.Namespace(structures=list(ns.STRUCTURES),
                           platform=platform, **NS)
    n_campaigns = len(a.workloads) * a.k * len(a.structures)

    # (a) the windows: the builds, the ptrace captures (the only ones
    # while the lanes run) and BBV + k-means + emulate + lift, apart
    t0 = time.monotonic()
    for wl in a.workloads:
        hd.build_tools(wl)
    t_build = time.monotonic() - t0
    attempts: list = []         # (seconds, rc) of each tracer run
    run = subprocess.run

    def timed_run(cmd, *args, **kw):
        t = time.monotonic()
        proc = run(cmd, *args, **kw)
        if str(cmd[0]).endswith("nativetrace"):
            attempts.append((time.monotonic() - t, proc.returncode))
        return proc

    subprocess.run = timed_run
    t0 = time.monotonic()
    try:
        windows = ns._build_windows(a)
    finally:
        subprocess.run = run
    t_windows = time.monotonic() - t0
    # one capture that reached its end a workload; a short one is taken
    # again (hostdiff.run_tracer) and counted apart
    captures = [s for s, rc in attempts if rc == 0]
    retaken = len(attempts) - len(captures)
    if len(captures) != len(a.workloads) or any(
            len(w) != a.k for w in windows.values()):
        fail(f"(a) {len(captures)} captures ({retaken} short ones taken "
             f"again), windows "
             f"{ {wl: len(w) for wl, w in windows.items()} }")
    rows = []
    for wl, ws in windows.items():
        for trace, meta in ws:
            rows.append({"workload": wl, "uops": trace.n,
                         "macro_ops": meta["macro_ops"],
                         "lift_rate": meta["stats"]["lift_rate"],
                         "weight": meta["simpoint_weight"],
                         "interval": meta["simpoint_interval"]})
            log(f"(a) {wl} SimPoint interval {meta['simpoint_interval']}: "
                f"{trace.n} µops of {meta['macro_ops']} macro-ops, lift "
                f"rate {meta['stats']['lift_rate']:.4f}, weight "
                f"{meta['simpoint_weight']:.4f}")
    # each window spilled once (the fleet arm's tenants read these files)
    tenants = {name: (plan, wl, s) for name, plan, _w, wl, s in
               ns._fleet_tenants(a, windows, d)}
    t_capture = sum(s for s, _rc in attempts)
    timings["ns_windows"] = {
        "build_s": t_build, "capture_s": t_capture, "retaken": retaken,
        "emulate_lift_s": t_windows - t_capture, "windows": rows}
    log(f"(a) windows: builds {t_build:.1f} s, {len(captures)} captures "
        f"{t_capture:.1f} s ({retaken} short ones taken again), BBV + "
        f"k-means + emulate + lift {t_windows - t_capture:.1f} s")
    # (b)'s CPU side starts now, beside the card's arms
    pool = cf.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    held = {}
    for wl, s in NS_HELD:
        (trace, meta), = windows[wl]
        name = next(n for n, (_p, w, st) in tenants.items()
                    if (w, st) == (wl, s))
        keys = prng.trial_keys(prng.batch_key(prng.structure_key(
            prng.simpoint_key(prng.campaign_key(a.seed, "cpu"),
                              meta["simpoint_interval"]),
            ns.STRUCTURES.index(s)), 0), a.batch)
        npz = tenants[name][0].simpoints[0].path
        held[(wl, s)] = (name, trace.n, keys,
                         pool.submit(ns_cpu_tally, npz, s, keys.numpy()))
    marks("21 (a) windows")

    # (b) the serial arm, K1's count zeroed just before it; the first
    # batch of each campaign kept (its keys and tally)
    probe = K1Probe(torch)
    first: dict = {}
    tally_batch = campaign_mod.ShardedCampaign.tally_batch

    def kept_batch(camp, keys, *args, **kw):
        t = tally_batch(camp, keys, *args, **kw)
        key = (camp.kernel.trace.n, camp.structure)
        if key not in first:
            first[key] = (keys.cpu(), t.clone())
        return t

    campaign_mod.ShardedCampaign.tally_batch = kept_batch
    probe.reset()
    t0 = time.monotonic()
    try:
        serial = ns._run_serial(a, windows)
    finally:
        campaign_mod.ShardedCampaign.tally_batch = tally_batch
    t_serial = time.monotonic() - t0
    n_serial, max_err = probe.read("(b) serial arm")
    batches = 0
    for wl, row in serial["workloads"].items():
        for s, r in row["structures"].items():
            for sp in r["simpoints"]:
                if sp["trials"] % a.batch or sp["trials"] > a.max_trials:
                    fail(f"(b) {wl} {s}: {sp['trials']} trials")
            if not r["converged"] and all(sp["trials"] < a.max_trials
                                          for sp in r["simpoints"]):
                fail(f"(b) {wl} {s}: neither converged nor capped")
            want = sum(sp["weight"] * sp["avf"] for sp in r["simpoints"])
            # the document rounds each row and the sum to 4 places
            if abs(r["weighted_avf"] - want) > 1e-4 * len(r["simpoints"]):
                fail(f"(b) {wl} {s}: weighted AVF {r['weighted_avf']} != "
                     f"{want} over its SimPoint rows")
            batches += r["trials"] // a.batch
    if serial["campaigns"] != n_campaigns:
        fail(f"(b) {serial['campaigns']} campaigns, not {n_campaigns}")
    if n_serial != batches:
        fail(f"(b) K1 launched {n_serial} times for {batches} batches")
    launches["north star serial arm (21 b)"] = n_serial
    log(f"(b) serial arm: {serial['campaigns']} campaigns, "
        f"{serial['total_trials']} trials in {batches} batches, "
        f"{t_serial:.1f} s; K1 {n_serial} launches, one a batch, == plain "
        "on the first")
    marks("21 (b) serial arm")

    # (c) the fleet arm from a cold kernel registry, K1's count zeroed
    # just before it; the scheduler kept for the solo comparison
    exec_cache.cache().clear()
    exec_cache.clear_kernels()
    scheds: list = []
    init = sched_mod.CampaignScheduler.__init__

    def kept_init(self, *args, **kw):
        init(self, *args, **kw)
        scheds.append(self)

    sched_mod.CampaignScheduler.__init__ = kept_init
    # the batches dispatched: the pipelined engine runs intervals ahead,
    # and drops those past a tenant's stop (speculation), so K1 launches
    # once a dispatched batch, consumed or dropped
    dispatched = [0]
    steps = {}
    for meth, width in (("tally_batch", lambda keys: 1),
                        ("tally_batch_stratified", lambda keys: 1),
                        ("dispatch_interval", len)):
        steps[meth] = step = getattr(campaign_mod.ShardedCampaign, meth)

        def counted(camp, keys, *args, _step=step, _width=width, **kw):
            dispatched[0] += _width(keys)
            return _step(camp, keys, *args, **kw)

        setattr(campaign_mod.ShardedCampaign, meth, counted)
    probe.reset()
    t0 = time.monotonic()
    try:
        fleet = ns._run_fleet(a, windows, d)
    finally:
        sched_mod.CampaignScheduler.__init__ = init
        for meth, step in steps.items():
            setattr(campaign_mod.ShardedCampaign, meth, step)
    t_fleet = time.monotonic() - t0
    n_fleet, err = probe.read("(c) fleet arm")
    max_err = max(max_err, err)
    sched = scheds[-1]
    fb = a.fleet_batch
    if fleet["rc"] != 0 or fleet["tenants"] != n_campaigns:
        fail(f"(c) fleet rc {fleet['rc']}, {fleet['tenants']} tenants")
    for name, t in sched.tenants.items():
        row = fleet["workloads"][tenants[name][1]]["structures"][
            tenants[name][2]]
        if t.status != "complete" or t.trials % fb or \
                t.trials > a.max_trials or not (
                    row["converged"] or t.trials == a.max_trials):
            fail(f"(c) {name}: {t.status}, {t.trials} trials, converged "
                 f"{row['converged']}")
    fleet_batches = sum(t.batches for t in sched.tenants.values())
    if n_fleet != dispatched[0] or fleet_batches > dispatched[0]:
        fail(f"(c) K1 launched {n_fleet} times for {dispatched[0]} batches "
             f"dispatched, {fleet_batches} consumed")
    launches["north star fleet arm (21 c)"] = n_fleet
    solo_s = {}
    for wl, s in NS_HELD:
        name = held[(wl, s)][0]
        t1 = time.monotonic()
        orch = Orchestrator(CampaignPlan.from_dict(
            sched.tenants[name].spec.plan), device=NS_DEVICE)
        list(orch.events())
        solo_s[name] = time.monotonic() - t1
        solo = {k: (r.tallies.tolist(), r.trials)
                for k, r in orch.results.items()}
        got = {k: (v.tolist(), sched.tenants[name].trials)
               for k, v in sched.tenant_tallies(name).items()}
        if got != solo:
            fail(f"(c) {name}: fleet {got} != its solo run {solo}")
    speedup = t_serial / t_fleet
    log(f"(c) fleet arm: rc 0, {fleet['tenants']} tenants complete "
        f"({fleet['total_trials']} trials, {fleet_batches} batches of {fb}, "
        f"{dispatched[0] - fleet_batches} more dispatched ahead and "
        f"dropped, {fleet['fleet_ticks']} ticks, fairness "
        f"{fleet['fairness_index']}), {t_fleet:.1f} s; K1 {n_fleet} "
        f"launches, one a dispatched batch, == plain; "
        + ", ".join(f"{n} == its solo run ({v:.1f} s)"
                    for n, v in solo_s.items())
        + f"; a reading: serial {t_serial:.1f} s / fleet {t_fleet:.1f} s "
        f"= x{speedup:.3f} on {card}")
    # (b)'s CPU side: the first batch of each held campaign
    for (wl, s), (name, n, keys, fut) in held.items():
        card_keys, card_tally = first[(n, s)]
        cpu_tally = fut.result()
        if not torch.equal(card_keys, keys) or \
                card_tally.tolist() != cpu_tally:
            fail(f"(b) {wl} {s}: first batch on the card "
                 f"{card_tally.tolist()} != the CPU's {cpu_tally}")
        log(f"(b) {wl} {s}: the first batch's tally on the card == the "
            f"CPU's, {cpu_tally}")
    pool.shutdown()
    timings["ns_serial"] = {
        "wall_s": t_serial, "trials": serial["total_trials"],
        "batches": batches, "k1_launches": n_serial,
        "campaigns": {f"{wl} {s}": {"trials": r["trials"],
                                    "avf": r["weighted_avf"],
                                    "converged": r["converged"],
                                    "wall_s": r["wall_clock_s"]}
                      for wl, row in serial["workloads"].items()
                      for s, r in row["structures"].items()}}
    timings["ns_fleet"] = {
        "wall_s": t_fleet, "trials": fleet["total_trials"],
        "batches": fleet_batches, "dispatched": dispatched[0],
        "k1_launches": n_fleet,
        "ticks": fleet["fleet_ticks"],
        "fairness_index": fleet["fairness_index"],
        "exec_cache": fleet["exec_cache"], "solo_s": solo_s,
        "speedup_reading": speedup}
    marks("21 (c) fleet arm")

    # (d) tools.simpoint_avf, its windows kept for the oracle
    kept_windows: list = []
    simpoint_windows = simpoint_mod.simpoint_windows

    def keep_windows(*args, **kw):
        out = simpoint_windows(*args, **kw)
        kept_windows.append(out[0])
        return out

    simpoint_mod.simpoint_windows = keep_windows
    out = os.path.join(d, "simpoint_avf.json")
    probe.reset()
    t0 = time.monotonic()
    try:
        _cli_stdout(simpoint_avf.main, [
            "--workload", NS_SA["workload"], "--k", str(NS_SA["k"]),
            "--trials", str(NS_SA["trials"]), "--out", out]
            + (["--platform", platform] if platform else []))
    finally:
        simpoint_mod.simpoint_windows = simpoint_windows
    t_sa = time.monotonic() - t0
    n_sa, err = probe.read("(d) simpoint_avf")
    max_err = max(max_err, err)
    probe.close()
    doc = _read_json(out)
    (sa_windows,) = kept_windows
    if len(doc["windows"]) != len(sa_windows) or n_sa != len(sa_windows):
        fail(f"(d) {len(doc['windows'])} windows in the document, "
             f"{len(sa_windows)} selected, {n_sa} K1 launches")
    root = prng.campaign_key(NS["seed"], NS_DEVICE)
    for row, (trace, meta) in zip(doc["windows"], sa_windows):
        if sum(row["tally"]) != NS_SA["trials"]:
            fail(f"(d) window {row['interval']}: tally {row['tally']}")
        kernel = TrialKernel(trace, O3Config(), device=NS_DEVICE)
        keys = prng.trial_keys(prng.batch_key(prng.structure_key(
            prng.simpoint_key(root, meta["simpoint_interval"]), 0), 0),
            NS_SA["trials"])[:NS_SA["oracle"]]
        faults = kernel.sample_batch(keys, "regfile")
        bad = int((kernel.run_batch_hybrid(faults, may_latch=False)
                   != kernel.oracle_outcomes(faults)).sum())
        if bad:
            fail(f"(d) window {row['interval']}: {bad}/{NS_SA['oracle']} "
                 "outcomes differ from the C++ oracle")
    launches["simpoint_avf regfile (21 d)"] = n_sa
    timings["ns_simpoint_avf"] = {
        "wall_s": t_sa, "k_selected": doc["k_selected"],
        "weighted_avf": doc["weighted_avf"],
        "windows": [{k: r[k] for k in ("interval", "weight", "uops",
                                       "avf", "tally", "seconds")}
                    for r in doc["windows"]]}
    log(f"(d) simpoint_avf {NS_SA['workload']}: {doc['k_selected']} "
        f"windows ({', '.join(str(r['uops']) for r in doc['windows'])} "
        f"µops), tallies of {NS_SA['trials']} each, weighted AVF "
        f"{doc['weighted_avf']}, {NS_SA['oracle']} outcomes a window == "
        f"the C++ oracle; K1 {n_sa} launches, == plain; {t_sa:.1f} s")
    shutil.rmtree(d, ignore_errors=True)
    timings["northstar_phase_s"] = time.monotonic() - t_phase
    marks("21 (d) simpoint_avf")
    return {"timings": timings, "launches": launches, "k1_max_err": max_err}


class HostMemo:
    """The port's ``hostdiff`` in phase 22: each binary captured and lifted
    once per argument list and the host's ptrace SFI run once per
    coordinate list (two captures of one binary differ, and so may two
    host runs), so that a card run and a CPU run take the same ones; each
    call of ``run_host``, ``run_device`` and the extended capture
    counted, cached or not."""

    ONCE = ("capture_and_lift", "capture_and_lift_to_output", "run_host")

    def __init__(self):
        from shrewd_tpu_torch.ingest import hostdiff as hd

        self.hd, self.memo = hd, {}
        self.calls = dict.fromkeys(self.ONCE + ("run_device",), 0)
        self.saved = {n: getattr(hd, n) for n in self.calls}
        for name in self.ONCE:
            setattr(hd, name, self._once(name, self.saved[name]))
        run_device = self.saved["run_device"]

        def counted(*a, **kw):
            self.calls["run_device"] += 1
            return run_device(*a, **kw)

        hd.run_device = counted

    @staticmethod
    def key(name: str, paths, a: tuple, kw: dict) -> tuple:
        arg = np.asarray(a[0]).tobytes() if name == "run_host" else a
        return (name, str(paths.workload), arg,
                tuple(sorted((k, repr(v)) for k, v in kw.items())))

    def _once(self, name, real):
        def run(paths, *a, **kw):
            self.calls[name] += 1
            key = self.key(name, paths, a, kw)
            if key not in self.memo:
                self.memo[key] = real(paths, *a, **kw)
            return self.memo[key]
        return run

    def close(self) -> None:
        for name, real in self.saved.items():
            setattr(self.hd, name, real)


class KeptOutcomes:
    """``TrialKernel.run_keys`` wrapped (phase 22): the outcomes of each
    call's first ``n`` keys, by (the kernel's config, structure).  A
    trial key fixes its outcome whatever the batch, so they are held
    against the same keys run alone on the CPU."""

    def __init__(self, n: int):
        from shrewd_tpu_torch.ops.trial import TrialKernel

        self.cls, self.run_keys, self.kept = TrialKernel, \
            TrialKernel.run_keys, {}
        run_keys, kept = self.run_keys, self.kept

        def keeping(kernel, keys, structure):
            hybrid = kernel.run_batch_hybrid

            def rec(faults, may_latch=True):
                out = hybrid(faults, may_latch=may_latch)
                kept[(cfg_key(kernel.cfg), structure)] = out[:n].copy()
                return out

            kernel.run_batch_hybrid = rec
            try:
                return run_keys(kernel, keys, structure)
            finally:
                del kernel.run_batch_hybrid

        TrialKernel.run_keys = keeping

    def close(self) -> None:
        self.cls.run_keys = self.run_keys


def cfg_key(cfg) -> str:
    return json.dumps(cfg.to_dict(), sort_keys=True)


def val_cpu_outcomes(trace, meta, jobs) -> list:
    """Phase 22's CPU side, in a spawned process of its own (one torch
    thread), beside the card's runs: for each (config, structure, keys,
    with the memmap) the outcomes on the CPU (no held structure is latch,
    so ``may_latch`` is off, as ``run_keys`` runs them)."""
    import os

    import torch

    from shrewd_tpu_torch.ingest import hostdiff as hd
    from shrewd_tpu_torch.models.o3 import O3Config
    from shrewd_tpu_torch.ops.trial import TrialKernel

    os.nice(10)
    torch.set_num_threads(1)
    out = []
    for cfg, structure, keys, memmap in jobs:
        kernel = TrialKernel(
            trace, O3Config.from_dict(json.loads(cfg)), device="cpu",
            memmap=hd.memmap_from_meta(meta, device="cpu") if memmap
            else None)
        out.append(kernel.run_batch_hybrid(kernel.sample_batch(
            torch.as_tensor(keys), structure), may_latch=False).tolist())
    return out


def validation_phase(torch, marks, card) -> dict:
    """Phase 22 (a), (d) and (e), the validation tools that capture or
    ptrace, in the ``ns`` lane → the timings and where (a)'s window was
    left for (b) and (c).  (a) ``tools.timing_validate``, (d)
    ``tools.diff_artifacts``, (e) ``tools.threeway_diff``; (b)
    ``tools.timing_effect`` and (c) ``tools.protect_validate`` run in a
    child process of ``main`` once the lanes end
    (``validation_child_part``), on the window (a) lifted.  Every gate
    holds the card against the port on the CPU or the tool's own rules,
    never against a number pinned elsewhere: the workloads are built with
    this machine's gcc.  The tools' captures and host runs are taken once
    and shared by their card and CPU runs (``HostMemo``); the lane's only
    other captures are phase 21's, before them."""
    import hashlib
    import os
    import pickle
    import shutil
    import tempfile

    from shrewd_tpu_torch.ingest import hostdiff as hd
    from shrewd_tpu_torch.tools import (diff_artifacts, threeway_diff,
                                        timing_validate)

    t_phase = time.monotonic()
    timings: dict = {"card": card}
    d = tempfile.mkdtemp(prefix="chip_smoke_val_")
    plat = ["--platform", "cpu"] if NS_DEVICE == "cpu" else []
    memo = HostMemo()
    try:
        # (a) timing_validate, then the same on the CPU from the same
        # capture; the rdtsc figures are readings of this host
        t0 = time.monotonic()
        tv = {}
        for name, extra in (("card", plat), ("cpu", ["--platform", "cpu"])):
            out = os.path.join(d, f"tv_{name}.json")
            _cli_stdout(timing_validate.main, ["--workload", VAL["workload"],
                                               "--out", out, *extra])
            tv[name] = _read_json(out)
        same = ("macro_ops", "uops", "proxy_cycles", "scoreboard_cycles",
                "scoreboard_squash_cycles")
        if any(tv["card"][f] != tv["cpu"][f] for f in same):
            fail(f"(a) timing_validate: card {[tv['card'][f] for f in same]}"
                 f" != CPU {[tv['cpu'][f] for f in same]}")
        t_a = time.monotonic() - t0
        tva = tv["card"]
        log(f"(a) timing_validate {VAL['workload']}: {tva['macro_ops']} "
            f"macro-ops, {tva['uops']} µops, scoreboard "
            f"{tva['scoreboard_cycles']} / squash "
            f"{tva['scoreboard_squash_cycles']} cycles == the CPU run's; a "
            f"reading of this host: rdtsc median {tva['host_cycles_median']}"
            f" cycles (ratios proxy {tva['ratio_proxy_vs_host']}, "
            f"scoreboard {tva['ratio_scoreboard_vs_host']}, squash "
            f"{tva['ratio_squash_vs_host']}); {t_a:.1f} s")
        timings["val_timing_validate"] = {
            "wall_s": t_a, **{f: tva[f] for f in same},
            "host_cycles_median": tva["host_cycles_median"],
            "ratio_scoreboard_vs_host": tva["ratio_scoreboard_vs_host"]}
        # (b) and (c)'s window, for their child process
        lift = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_val_bc_"),
                            "lift.pkl")
        with open(lift, "wb") as f:
            pickle.dump(memo.memo[memo.key(
                "capture_and_lift", hd.build_tools(VAL["workload"]), (),
                {})], f)
        marks("22 (a) timing_validate")

        # (d) diff_artifacts in fp mode
        t0 = time.monotonic()
        out = os.path.join(d, "da.json")
        _cli_stdout(diff_artifacts.main, [
            "--mode", "fp", "--workloads", VAL["fp_workload"], "--trials",
            str(VAL["fp_trials"]), "--out", out, *plat])
        t_d = time.monotonic() - t0
        da = _read_json(out)
        row = da["workloads"][VAL["fp_workload"]]
        if "error" in row or "summary" not in da:
            fail(f"(d) diff_artifacts: {row}")
        esc = escalations(row, "(d) diff_artifacts")
        log(f"(d) diff_artifacts --mode fp {VAL['fp_workload']}, "
            f"{VAL['fp_trials']} trials: host AVF {row['host_avf']}, device "
            f"AVF {row['device_avf']}, agreement {row['agreement_exact']}, "
            f"escalations {esc}, {row.get('uops')} µops; {t_d:.1f} s")
        timings["val_diff_fp"] = {"wall_s": t_d, **{
            k: row[k] for k in ("host_avf", "device_avf", "agreement_exact",
                                "agreement_vulnerable")}, **esc}
        marks("22 (d) diff_artifacts")

        # (e) threeway_diff: the sort.c golden, refused unless this
        # machine's gcc builds gem5's binary
        t0 = time.monotonic()
        golden = _read_json(VAL["golden"])
        wl = threeway_diff.golden_workload(golden)
        with open(hd.build_tools(wl).workload, "rb") as f:
            sha = hashlib.sha256(f.read()).hexdigest()
        log(f"(e) {wl} built here: sha256 {sha[:12]}; the golden's "
            f"{golden['binary_sha'][:12]}")
        before = dict(memo.calls)
        children: list = []
        run = subprocess.run

        def seen_run(cmd, *a, **kw):
            if str(cmd[0]).endswith(("hostsfi", "nativetrace")):
                children.append(cmd[0])
            return run(cmd, *a, **kw)

        subprocess.run = seen_run
        try:
            if sha != golden["binary_sha"]:
                try:
                    threeway_diff.main(["--golden", VAL["golden"], "--out",
                                        os.path.join(d, "tw.json"), *plat])
                    fail("(e) threeway_diff ran on another binary")
                except threeway_diff.BinaryMismatch as e:
                    msg = str(e)
            else:
                tw = {}
                trimmed = dict(golden,
                               trials=golden["trials"][:VAL["golden_trials"]])
                path = os.path.join(d, "golden.json")
                with open(path, "w") as f:
                    json.dump(trimmed, f)
                for name, extra in (("card", plat),
                                    ("cpu", ["--platform", "cpu"])):
                    out = os.path.join(d, f"tw_{name}.json")
                    _cli_stdout(threeway_diff.main,
                                ["--golden", path, "--out", out, *extra])
                    tw[name] = _read_json(out)
        finally:
            subprocess.run = run
        calls = {k: memo.calls[k] - before[k] for k in memo.calls}
        if sha != golden["binary_sha"]:
            if sum(calls.values()) or children:
                fail(f"(e) the refusal started work: {calls}, {children}")
            want = (f"built {wl} sha {sha[:12]} != golden artifact's "
                    f"{golden['binary_sha'][:12]}")
            proc = subprocess.run(
                [sys.executable, "-m", "shrewd_tpu_torch.tools.threeway_diff",
                 "--golden", VAL["golden"], "--out",
                 os.path.join(d, "tw_cli.json"), *plat],
                capture_output=True, text=True)
            if not msg.startswith(want) or proc.returncode == 0 or \
                    want not in proc.stderr or \
                    os.path.exists(os.path.join(d, "tw_cli.json")):
                fail(f"(e) refusal: {msg!r}; python -m rc "
                     f"{proc.returncode}: {proc.stderr[-1000:]}")
            log(f"(e) threeway_diff refuses another binary before any work "
                f"(no run_host, capture or run_device call, no ptrace child;"
                f" python -m rc {proc.returncode}): {msg}")
            timings["val_threeway"] = {"refused": True, "sha": sha,
                                       "golden_sha": golden["binary_sha"],
                                       "rc": proc.returncode}
        else:
            scrubbed = [{k: v for k, v in tw[n].items() if k != "card"}
                        for n in ("card", "cpu")]
            if scrubbed[0] != scrubbed[1]:
                fail(f"(e) threeway card {tw['card']['tallies']} != CPU "
                     f"{tw['cpu']['tallies']}")
            log(f"(e) threeway_diff on {VAL['golden_trials']} golden trials:"
                f" tallies {tw['card']['tallies']}, agreement "
                f"{tw['card']['agreement_exact']}, == the CPU run's")
            timings["val_threeway"] = {"refused": False, "sha": sha,
                                       "tallies": tw["card"]["tallies"]}
        timings["val_threeway"]["wall_s"] = time.monotonic() - t0
        marks("22 (e) threeway_diff")

    finally:
        memo.close()
        shutil.rmtree(d, ignore_errors=True)
    timings["validation_phase_s"] = time.monotonic() - t_phase
    return {"timings": timings, "lift": lift}


def validation_child_part(torch, card, lift: str) -> dict:
    """Phase 22 (b) and (c), ``tools.timing_effect`` and
    ``tools.protect_validate`` on the window phase 22 (a) lifted (its
    capture shared through ``HostMemo``) → the timings, K1's launches and
    K1's largest difference from its plain version.  (b): K1's count
    zeroed just before the tool, one launch a ``run_keys``; (c): no K1
    launch, every lane on the memmap dense replay, the rc its ``pass``
    gives.  Each held (config, structure)'s first ``VAL["held"]`` outcomes
    are held against the CPU's (a spawned process beside the card's
    runs)."""
    import concurrent.futures as cf
    import multiprocessing
    import os
    import pickle
    import shutil
    import tempfile

    from shrewd_tpu_torch.ingest import hostdiff as hd
    from shrewd_tpu_torch.models.o3 import O3Config
    from shrewd_tpu_torch.ops import taint_cuda
    from shrewd_tpu_torch.tools import protect_validate, timing_effect
    from shrewd_tpu_torch.utils import prng

    with open(lift, "rb") as f:
        trace, meta = pickle.load(f)
    shutil.rmtree(os.path.dirname(lift), ignore_errors=True)
    plat = ["--platform", "cpu"] if NS_DEVICE == "cpu" else []
    held = VAL["held"]
    te_keys = prng.trial_keys(prng.campaign_key(17, "cpu"), held).numpy()
    pv_keys = prng.trial_keys(prng.campaign_key(77, "cpu"), held).numpy()
    pv_cfg = cfg_key(O3Config(shadow_model="fupool"))
    jobs = [(cfg_key(cfg), VAL["structure"], te_keys, False)
            for cfg in timing_effect.models().values()] + \
        [(pv_cfg, "fu", pv_keys, True)]
    pool = cf.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    fut = pool.submit(val_cpu_outcomes, trace, meta, jobs)
    memo = HostMemo()
    memo.memo[memo.key("capture_and_lift", hd.build_tools(VAL["workload"]),
                       (), {})] = (trace, meta)
    kept = KeptOutcomes(held)
    d = tempfile.mkdtemp(prefix="chip_smoke_val_bc_")
    try:
        # (b) timing_effect, K1's count zeroed just before it
        probe = K1Probe(torch)
        probe.reset()
        t0 = time.monotonic()
        out = os.path.join(d, "te.json")
        _cli_stdout(timing_effect.main, [
            "--workload", VAL["workload"], "--trials", str(VAL["trials"]),
            "--out", out, *plat])
        t_b = time.monotonic() - t0
        n_b, max_err = probe.read("(b) timing_effect")
        probe.close()
        te = _read_json(out)
        n_runs = len(te["structures"]) * 3
        if n_runs != 12 or n_b != n_runs:
            fail(f"(b) K1 launched {n_b} times for {n_runs} run_keys")
        for s, row in te["structures"].items():
            for m in ("proxy", "scoreboard", "squash"):
                if sum(row[m]["tally"]) != VAL["trials"]:
                    fail(f"(b) {s} {m}: tally {row[m]['tally']}")
        log(f"(b) timing_effect {VAL['workload']}, {VAL['trials']} trials: "
            f"{te['window_uops']} µops, AVF proxy / scoreboard / squash "
            + "; ".join(f"{s} {r['proxy']['avf']} / "
                        f"{r['scoreboard']['avf']} / {r['squash']['avf']}"
                        for s, r in te["structures"].items())
            + f"; K1 {n_b} launches, one a run_keys, == plain on the first; "
            f"{t_b:.1f} s")

        # (c) protect_validate: every lane on the memmap dense replay
        taint_cuda.taint_fast_cuda.launches = 0
        t0 = time.monotonic()
        out = os.path.join(d, "pv.json")
        rc, _, err = _cli_run(protect_validate.main, [
            "--workload", VAL["workload"], "--trials", str(VAL["trials"]),
            "--out", out, *plat])
        t_c = time.monotonic() - t0
        pv = _read_json(out)
        leg = pv["shadow_leg"]
        if rc != (0 if pv["pass"] else 1):
            fail(f"(c) protect_validate rc {rc} with pass {pv['pass']}: "
                 f"{err[-2000:]}")
        if taint_cuda.taint_fast_cuda.launches:
            fail(f"(c) K1 launched {taint_cuda.taint_fast_cuda.launches} "
                 "times on memmap kernels")
        if sum(leg["protected_tally"]) != VAL["trials"]:
            fail(f"(c) protected tally {leg['protected_tally']}")
        log(f"(c) protect_validate {VAL['workload']}, {VAL['trials']} "
            f"trials: rc {rc}, pass {pv['pass']} (shadow leg "
            f"{leg['pass']}: predicted SDC {leg['predicted']['sdc']}, "
            f"measured {leg['measured']['sdc']}, CI "
            f"{leg['measured_ci95']['sdc']}; parity leg "
            f"{pv['parity_leg']['pass']}); tallies unprotected "
            f"{leg['unprotected_tally']}, protected "
            f"{leg['protected_tally']}; no K1 launch (memmap: dense); "
            f"{t_c:.1f} s")

        # the CPU side: the held keys, lane for lane
        t0 = time.monotonic()
        for (cfg, s, _k, _m), want in zip(jobs, fut.result()):
            if (cfg, s) not in kept.kept or \
                    kept.kept[(cfg, s)].tolist() != want:
                fail(f"(b)/(c) {s} under {cfg[:120]}: the card's first "
                     f"{held} outcomes != the CPU's")
        log(f"(b), (c): the first {held} outcomes of {VAL['structure']} "
            "under the three timing models and of the protected fu leg == "
            f"the CPU's (waited {time.monotonic() - t0:.1f} s for the CPU)")
    finally:
        kept.close()
        memo.close()
        pool.shutdown()
        shutil.rmtree(d, ignore_errors=True)
    if memo.calls["capture_and_lift"] != 2:
        fail(f"(b), (c): {memo.calls['capture_and_lift']} lifts, not one "
             "each from (a)'s capture")
    return {"timings": {
        "card": card,
        "val_timing_effect": {
            "wall_s": t_b, "k1_launches": n_b,
            "window_uops": te["window_uops"],
            "avf": {s: {m: r[m]["avf"] for m in ("proxy", "scoreboard",
                                                 "squash")}
                    for s, r in te["structures"].items()}},
        "val_protect_validate": {
            "wall_s": t_c, "rc": rc, "pass": pv["pass"],
            "unprotected_tally": leg["unprotected_tally"],
            "protected_tally": leg["protected_tally"]}},
        "launches": {"timing_effect (22 b)": n_b}, "k1_max_err": max_err}


# the parts that run in child processes of this script beside phases
# 16-17 (``--child PART RESULT [ARGS]``): none starts a ptrace capture
CHILDREN = {"validation": ("validation_child_part", "22 (b) and (c)"),
            "window": ("window_child_part", "24 (b) and (c)")}


def child_main(part: str, result: str, *args: str) -> int:
    """``--child PART RESULT [ARGS]``: one of ``CHILDREN``, started by
    ``main`` once the lanes end and run beside phases 16-17 (phase 22's
    window comes from ARGS, phase 24's from the tool's cache); writes the
    part's result to RESULT as JSON."""
    import os

    import torch

    from shrewd_tpu_torch import native
    from shrewd_tpu_torch.ops import taint_cuda

    taint_cuda.build()
    native.build()
    doc = globals()[CHILDREN[part][0]](torch, card_line(), *args)
    tmp = f"{result}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, result)
    return 0


def strat_cpu_first(batch: int) -> dict:
    """Phase 23's CPU side, in a spawned process of its own (one torch
    thread), beside the card's run: each tier's first batch of
    ``tools.strat_effect`` on the CPU → {tier: stratified tally}."""
    import os

    import torch

    from shrewd_tpu_torch.tools import strat_effect
    from shrewd_tpu_torch.utils import prng

    os.nice(10)
    torch.set_num_threads(1)
    out = {}
    for name, kernel, structure, cap, seed0 in strat_effect.tiers("cpu"):
        keys = prng.trial_keys(prng.campaign_key(seed0, "cpu"),
                               batch if cap is None else min(batch, cap))
        out[name] = kernel.run_keys_stratified(keys, structure)[0].tolist()
    return out


def strat_phase(torch, marks, card) -> dict:
    """Phase 23, ``tools.strat_effect`` on the card at ``STRAT`` → the
    timings, K1's launches (one a batch of each O3 tier) and K1's largest
    difference from its plain version; each tier's first batch of
    stratified tallies held against the same batch on the CPU."""
    import concurrent.futures as cf
    import multiprocessing
    import os
    import tempfile

    from shrewd_tpu_torch.models.tier import TierKernel
    from shrewd_tpu_torch.ops.trial import TrialKernel
    from shrewd_tpu_torch.tools import strat_effect

    t_phase = time.monotonic()
    plat = ["--platform", "cpu"] if NS_DEVICE == "cpu" else []
    pool = cf.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    fut = pool.submit(strat_cpu_first, STRAT["batch"])
    # the first batch of each (kernel, structure) the tool runs
    first: dict = {}
    saved = {cls: cls.run_keys_stratified for cls in (TrialKernel,
                                                      TierKernel)}
    for cls, real in saved.items():
        def kept(kernel, keys, structure=None, _real=real):
            st = _real(kernel, keys, structure)
            first.setdefault((type(kernel).__name__, structure),
                             st[0].tolist())
            return st
        cls.run_keys_stratified = kept
    probe = K1Probe(torch)
    probe.reset()
    d = tempfile.mkdtemp(prefix="chip_smoke_strat_")
    out = os.path.join(d, "strat.json")
    t0 = time.monotonic()
    try:
        _cli_stdout(strat_effect.main, [
            "--batches", str(STRAT["batches"]), "--batch",
            str(STRAT["batch"]), "--out", out, *plat])
    finally:
        for cls, real in saved.items():
            cls.run_keys_stratified = real
    t_run = time.monotonic() - t0
    n, max_err = probe.read("23 strat_effect")
    probe.close()
    doc = _read_json(out)
    os.remove(out)
    os.rmdir(d)
    if n != 2 * STRAT["batches"]:
        fail(f"23: K1 launched {n} times for 2 O3 tiers x "
             f"{STRAT['batches']} batches")
    t0 = time.monotonic()
    cpu = fut.result()
    pool.shutdown()
    kinds = {"o3": "TrialKernel", "mesi": "MesiKernel", "noc": "NocKernel"}
    for name, want in cpu.items():
        kind, structure = name.split(":")
        got = first.get((kinds[kind], structure))
        if got != want:
            fail(f"23 {name}: the first batch on the card {got} != the "
                 f"CPU's {want}")
    if list(doc["tiers"]) != list(cpu):
        fail(f"23: tiers {list(doc['tiers'])}")
    log("23 strat_effect at batch " + str(STRAT["batch"]) + ", "
        + str(STRAT["batches"]) + " batches: trials-reduction factor "
        + ", ".join(f"{k} {v['trials_reduction_factor']}"
                    for k, v in doc["tiers"].items())
        + f"; each tier's first batch == the CPU's (waited "
        f"{time.monotonic() - t0:.1f} s for it); K1 {n} launches, one a "
        f"batch of each O3 tier, == plain on the first; {t_run:.1f} s")
    marks("23 strat_effect")
    return {"timings": {
        "card": card, "strat_s": t_run, "batches": STRAT["batches"],
        "batch": STRAT["batch"], "k1_launches": n,
        "tiers": doc["tiers"],
        "strat_phase_s": time.monotonic() - t_phase},
        "launches": {"strat_effect o3 (23)": n}, "k1_max_err": max_err}


def window_build_phase(torch, marks, card) -> dict:
    """Phase 24 (a), ``tools.bigwindow --build`` in the ``ns`` lane after
    phase 22 (the lane's captures one after another): ``WINDOW``'s
    workload captured once under ptrace, cut at ``WINDOW["max_steps"]``
    macro-steps, and lifted at each of ``WINDOW["lengths"]`` into the
    tool's cache, where (b) and (c) read them → the timings and each
    window's µops."""
    import os
    import shutil
    import tempfile

    from shrewd_tpu_torch.tools import bigwindow

    plat = ["--platform", "cpu"] if NS_DEVICE == "cpu" else []
    d = tempfile.mkdtemp(prefix="chip_smoke_bw_")
    out = os.path.join(d, "build.json")
    t0 = time.monotonic()
    try:
        _cli_stdout(bigwindow.main, [
            "--build", "--lengths", *map(str, WINDOW["lengths"]),
            "--max-steps", str(WINDOW["max_steps"]), "--workload",
            WINDOW["workload"], "--out", out, *plat])
        t_build = time.monotonic() - t0
        doc = _read_json(out)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    b = doc["build"]
    uops = {n: b[f"lift_{n}"]["uops"] for n in WINDOW["lengths"]}
    if not b["capture_truncated"] or any(u < n for n, u in uops.items()):
        fail(f"24 (a): capture truncated {b['capture_truncated']}, windows "
             f"{uops}")
    if doc["card"] != (card if NS_DEVICE == "cuda" else None):
        fail(f"24 (a): the document's card {doc['card']!r}")
    log(f"24 (a) bigwindow --build {WINDOW['workload']}: capture "
        f"{b['capture_steps']} macro-steps (cut at --max-steps "
        f"{WINDOW['max_steps']}) in {b['capture_seconds']} s; "
        + "; ".join(f"lift {n}: {b[f'lift_{n}']['uops']} µops, rate "
                    f"{b[f'lift_{n}']['lift_rate']}, "
                    f"{b[f'lift_{n}']['seconds']} s"
                    for n in WINDOW["lengths"])
        + f"; {t_build:.1f} s")
    marks("24 (a) bigwindow --build")
    return {"timings": {"card": card, "build_s": t_build, "build": b,
                        "tools_s": doc["setup"].get("tools_seconds")},
            "uops": uops}


def window_cpu_outcomes(jobs, held: int) -> list:
    """Phase 24's CPU side, in a spawned process of its own (one torch
    thread), beside the card's runs: for each (window file, chunk — None
    for the dense path) the outcomes of the first ``held`` keys of
    ``tools.bigwindow``'s campaign key, regfile, on the CPU."""
    import os

    import torch

    from shrewd_tpu_torch.models.o3 import O3Config
    from shrewd_tpu_torch.ops.chunked import ChunkedCampaign
    from shrewd_tpu_torch.ops.trial import TrialKernel
    from shrewd_tpu_torch.trace import format as tfmt
    from shrewd_tpu_torch.utils import prng

    os.nice(10)
    torch.set_num_threads(1)
    keys = prng.trial_keys(prng.campaign_key(0, "cpu"), held)
    out = []
    for path, chunk in jobs:
        kernel = TrialKernel(tfmt.load(path)[0], O3Config(), device="cpu")
        if chunk is None:
            got = kernel.run_batch_hybrid(
                kernel.sample_batch(keys, "regfile"), may_latch=False)
        else:
            got = ChunkedCampaign(kernel, chunk=chunk).outcomes_from_keys(
                keys, "regfile")
        out.append(np.asarray(got).tolist())
    return out


class ChunkProbe:
    """The chunked path's instrumentation in phase 24 (c): each
    ``outcomes_of_faults`` call's first ``n`` outcomes by window length and
    its waves, the exact engine's waves, and the first K2 launch of each
    chunk length, kept for the comparison with the plain version."""

    def __init__(self, n: int):
        from shrewd_tpu_torch.ops import chunked as CH

        self.CH, self.cls = CH, CH.ChunkedCampaign
        self.real = (CH.taint_chunk_cuda, self.cls.outcomes_of_faults,
                     self.cls._trial_chunk)
        launch, outcomes_of, trial_chunk = self.real
        self.kept: dict = {}
        self.first_wave: dict = {}
        self.waves = self.exact_waves = 0

        def k2(gold, tr, *a, **kw):
            got = launch(gold, tr, *a, **kw)
            self.first_wave.setdefault(tr.n, ((gold, tr, *a), kw, got))
            return got

        def keeping(camp, faults):
            out = outcomes_of(camp, faults)
            self.kept[camp.n] = out[:n].copy()
            self.waves += camp.last_stats["waves"]
            return out

        def counted(camp, *a):
            self.exact_waves += 1
            return trial_chunk(camp, *a)

        CH.taint_chunk_cuda = k2
        self.cls.outcomes_of_faults = keeping
        self.cls._trial_chunk = counted

    def close(self) -> None:
        (self.CH.taint_chunk_cuda, self.cls.outcomes_of_faults,
         self.cls._trial_chunk) = self.real


def window_child_part(torch, card) -> dict:
    """Phase 24 (b) and (c), ``tools.bigwindow --rate`` on the windows (a)
    built, in a child process beside phases 16-17 (no capture) → the
    timings, the launches and the kernels' largest differences from their
    plain versions.  (b) the dense rate at ``WINDOW["dense"]``, K1's count
    zeroed just before it: one launch a ``run_keys`` (the warm call and
    ``WINDOW["reps"]`` timed), the first bitwise equal to its plain
    version, no K2 launch; (c) the chunked rate at every length, chunk
    ``WINDOW["chunk"]``, K2's count zeroed just before it: one launch a
    fast wave, the first wave of each chunk length bitwise equal to its
    plain version, no K1 launch.  The first ``WINDOW["held"]`` keys of
    each run are held against the CPU's (two spawned processes beside the
    card's runs), and the chunked outcomes on the dense window against
    the dense ones."""
    import concurrent.futures as cf
    import multiprocessing
    import os
    import shutil
    import tempfile

    from shrewd_tpu_torch.models.o3 import O3Config
    from shrewd_tpu_torch.ops import taint_cuda
    from shrewd_tpu_torch.ops.taint import taint_chunk
    from shrewd_tpu_torch.tools import bigwindow

    t_phase = time.monotonic()
    plat = ["--platform", "cpu"] if NS_DEVICE == "cpu" else []
    held, chunk, reps = WINDOW["held"], WINDOW["chunk"], WINDOW["reps"]
    stem = os.path.splitext(os.path.basename(WINDOW["workload"]))[0]
    path = {n: str(bigwindow.cache_path(stem, n)) for n in WINDOW["lengths"]}
    longest = max(WINDOW["lengths"])
    pool = cf.ProcessPoolExecutor(
        max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    jobs = [("dense", WINDOW["dense"], None)] + \
        [("chunked", n, chunk) for n in WINDOW["lengths"]]
    parts = ([j for j in jobs if j[1] != longest or j[0] == "dense"],
             [j for j in jobs if j[1] == longest and j[0] == "chunked"])
    futs = [(part, pool.submit(window_cpu_outcomes,
                               [(path[n], c) for _, n, c in part], held))
            for part in parts if part]
    kept = KeptOutcomes(held)
    probe = K1Probe(torch)
    chunks = None
    d = tempfile.mkdtemp(prefix="chip_smoke_bw_rate_")
    try:
        # (b) the dense rate, K1's count zeroed just before it
        probe.reset()
        taint_cuda.taint_chunk_cuda.launches = 0
        out = os.path.join(d, "dense.json")
        t0 = time.monotonic()
        _cli_stdout(bigwindow.main, [
            "--rate", "--lengths", str(WINDOW["dense"]), "--reps",
            str(reps), "--workload", WINDOW["workload"], "--out", out,
            *plat])
        t_b = time.monotonic() - t0
        log(f"24 (b) launches, counted from 0: K1 "
            f"{taint_cuda.taint_fast_cuda.launches}, K2 "
            f"{taint_cuda.taint_chunk_cuda.launches}")
        t0 = time.monotonic()
        n_k1, k1_err = probe.read("24 (b) bigwindow dense")
        t_k1_plain = time.monotonic() - t0
        if n_k1 != 1 + reps:
            fail(f"24 (b): K1 launched {n_k1} times for {1 + reps} "
                 "run_keys")
        if taint_cuda.taint_chunk_cuda.launches:
            fail("24 (b): K2 launched on the dense path")
        dense = _read_json(out)
        (u_d, row), = dense["rate"]["rates"].items()
        dense_kept = kept.kept[(cfg_key(O3Config()), "regfile")]
        log(f"24 (b) bigwindow dense {u_d} µops, batch {row['batch']}: "
            f"{row['trials_per_sec']:,} trials/s (median of {reps} after a "
            f"warm call of {row['compile_seconds']} s), tally "
            f"{row['tally']}; K1 {n_k1} launches, one a run_keys, == plain "
            f"on the first ({t_k1_plain:.1f} s); {t_b:.1f} s")

        # (c) the chunked rate, K2's count zeroed just before it
        chunks = ChunkProbe(held)
        probe.reset()
        taint_cuda.taint_chunk_cuda.launches = 0
        out = os.path.join(d, "chunked.json")
        t0 = time.monotonic()
        _cli_stdout(bigwindow.main, [
            "--rate", "--chunked", "--chunk", str(chunk), "--lengths",
            *map(str, WINDOW["lengths"]), "--reps", str(reps), "--workload",
            WINDOW["workload"], "--out", out, *plat])
        t_c = time.monotonic() - t0
        n_k2 = taint_cuda.taint_chunk_cuda.launches
        log(f"24 (c) launches, counted from 0: K1 "
            f"{taint_cuda.taint_fast_cuda.launches}, K2 {n_k2}")
        if taint_cuda.taint_fast_cuda.launches:
            fail("24 (c): K1 launched on the chunked path")
        fast_waves = chunks.waves - chunks.exact_waves
        if n_k2 < 1 or n_k2 != fast_waves:
            fail(f"24 (c): {n_k2} K2 launches for {fast_waves} fast waves")
        t0 = time.monotonic()
        k2_err = 0
        for s, (a, kw, got) in sorted(chunks.first_wave.items()):
            k2_err = max(k2_err, compare_chunk(
                torch, got, taint_chunk(*a, **{x: v for x, v in kw.items()
                                               if x != "stream"}),
                f"24 (c) the first {s}-step wave"))
        t_k2_plain = time.monotonic() - t0
        ch_doc = _read_json(out)
        ch_rows = dict(zip(WINDOW["lengths"],
                           ch_doc["rate"]["rates"].items()))
        for n, (u, row) in ch_rows.items():
            res = row["resolution"]
            log(f"24 (c) bigwindow chunked {u} µops, chunk {chunk} x "
                f"{row['chunks']}, batch {row['batch']}, "
                f"{row['lanes_per_call']} lanes a call: "
                f"{row['trials_per_sec']:,} trials/s (median of {reps} "
                f"after a warm call of {row['compile_seconds']} s; set-up "
                f"{row['setup_seconds']} s), tally {row['tally']}; "
                f"{res['waves']} waves, {res['lanes_run']} lanes run, "
                f"{res['carried']} carried, {res['fallback_lanes']} to the "
                f"exact fallback")
        log(f"24 (c): K2 {n_k2} launches = {fast_waves} fast waves "
            f"({chunks.exact_waves} exact waves beside them), the first "
            f"wave of each chunk length == plain ({t_k2_plain:.1f} s); "
            f"{t_c:.1f} s")

        # the CPU side, lane for lane; chunked == dense on the dense window
        t0 = time.monotonic()
        card_out = {("dense", WINDOW["dense"]): dense_kept}
        for n, (u, _row) in ch_rows.items():
            card_out[("chunked", n)] = chunks.kept[int(u)]
        for part, fut in futs:
            for (mode, n, _c), want in zip(part, fut.result()):
                if card_out[(mode, n)].tolist() != want:
                    fail(f"24: {mode} {n}: the card's first {held} outcomes "
                         "!= the CPU's")
        if card_out[("chunked", WINDOW["dense"])].tolist() != \
                dense_kept.tolist():
            fail(f"24: chunked != dense on the {u_d}-µop window")
        log(f"24: the first {held} outcomes of each run == the CPU's "
            f"(waited {time.monotonic() - t0:.1f} s for the CPU); chunked "
            f"== dense on the {u_d}-µop window, tally "
            f"{np.bincount(dense_kept, minlength=4).tolist()}")
    finally:
        kept.close()
        probe.close()
        if chunks is not None:
            chunks.close()
        pool.shutdown()
        shutil.rmtree(d, ignore_errors=True)
    return {"timings": {
        "card": card,
        "bigwindow_dense": {"wall_s": t_b, "k1_launches": n_k1,
                            "k1_plain_s": t_k1_plain,
                            "rates": dense["rate"]["rates"]},
        "bigwindow_chunked": {"wall_s": t_c, "k2_launches": n_k2,
                              "fast_waves": fast_waves,
                              "exact_waves": chunks.exact_waves,
                              "k2_plain_s": t_k2_plain,
                              "chunk": chunk,
                              "rates": ch_doc["rate"]["rates"]},
        "setup": {**dense["setup"], "chunked": ch_doc["setup"]},
        "window_phase_s": time.monotonic() - t_phase},
        "launches": {"bigwindow dense (24 b)": n_k1,
                     "bigwindow chunked (24 c)": n_k2},
        "k1_max_err": k1_err, "k2_max_err": k2_err}


def _cli_run(main, argv) -> tuple[int, str, str]:
    """Run one of the port's CLI ``main``s in-process → (rc, its standard
    output, its standard error)."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _cli_stdout(main, argv) -> str:
    """Run one of the port's CLI ``main``s in-process; rc 0 or fail; its
    standard output."""
    rc, out, err = _cli_run(main, argv)
    if rc != 0:
        fail(f"{argv}: rc {rc}: {err[-2000:]}")
    return out


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
    results of its phases by function name, and each lane's seconds (the
    lanes' directory, with the artifacts they kept, stays for phase 20
    (c))."""
    import os

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
    return results


def start_child(part: str, *args: str):
    """Start one of ``CHILDREN`` in a child process of this script, the
    leader of a process group of its own that ``stop_lanes`` kills whole
    → (its directory, its process)."""
    import os
    import tempfile

    d = tempfile.mkdtemp(prefix=f"chip_smoke_{part}_child_")
    with open(os.path.join(d, "out"), "w") as out, \
            open(os.path.join(d, "err"), "w") as err:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", part,
             os.path.join(d, "result.json"), *args], stdout=out,
            stderr=err, start_new_session=True)
    _lanes.append((f"{part}_child", proc))
    return d, proc


def join_child(part: str, d: str, proc) -> dict:
    """Wait for a child of ``start_child``, print its output, fail if it
    failed → its result."""
    import os
    import shutil

    try:
        rc = proc.wait(timeout=LANE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        rc = None
    what = CHILDREN[part][1]
    log(f"phase {what}, run in a child process beside phases 16-17:")
    for name, stream in (("out", sys.stdout), ("err", sys.stderr)):
        with open(os.path.join(d, name)) as f:
            stream.write(f.read())
        stream.flush()
    if rc != 0:
        stop_lanes()
        fail(f"phase {what} exited rc {rc}")
    doc = _read_json(os.path.join(d, "result.json"))
    shutil.rmtree(d, ignore_errors=True)
    return doc


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

    global KEEP_DIR
    KEEP_DIR = os.path.join(os.path.dirname(result), "keep")
    for fn in LANES[name]:
        t_mark[0] = time.monotonic()
        _PHASES[fn] = globals()[fn](torch, marks, card)
    phases = _PHASES
    tmp = f"{result}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump({"phases": phases, "wall_s": time.monotonic() - t0}, f)
    os.replace(tmp, result)
    return 0


def main() -> int:
    import os
    import shutil

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
    fed_run, cert_run = lanes["fed_phase"], lanes["certify_phase"]
    ns_run = lanes["northstar_phase"]
    val_run, strat_run = lanes["validation_phase"], lanes["strat_phase"]
    cli_run.pop("until_stats")
    obs_run = obs_phase(os.path.join(lanes_dir, "keep"), card)
    shutil.rmtree(lanes_dir, ignore_errors=True)
    # phase 22 (b) and (c) and phase 24 (b) and (c) in two child
    # processes beside phases 16-17
    children = {"validation": start_child("validation", val_run["lift"]),
                "window": start_child("window")}
    cert_run["timings"]["certify_c"] = obs_run
    log(json.dumps({"timings": cli_run["timings"]}))
    log(json.dumps({"timings": cert_run["timings"]}))
    log(json.dumps({"timings": lanes["tier_phase"]}))
    log(json.dumps({"timings": matrix_run["timings"]}))
    log(json.dumps({"timings": fed_run["timings"]}))
    log(json.dumps({"timings": ns_run["timings"]}))
    log(json.dumps({"timings": val_run["timings"]}))
    log(json.dumps({"timings": lanes["window_build_phase"]["timings"]}))
    log(json.dumps({"timings": strat_run["timings"]}))
    if fed_run["front"] != matrix_run["front"]:
        fail("19 (c): the federated matrix's Pareto front differs from "
             "phase 18's solo front")
    log(f"19 (c): the federated front == phase 18's solo front, bitwise "
        f"({len(fed_run['front'])} groups)")
    log(f"phases 11-15, 18-23 and 24 (a) in five processes: "
        f"{time.monotonic() - t_lanes:.1f} s (lanes "
        + ", ".join(f"{n} {s:.1f} s" for n, s in lanes["lane_s"].items())
        + ")")
    t_mark[0] = time.monotonic()
    ingest_run = ingest_phase(torch, marks, card)
    log(json.dumps({"timings": ingest_run["timings"]}))
    ckpt_run = checkpoint_phase(torch, marks, card)
    log(json.dumps({"timings": ckpt_run["timings"]}))
    child_run = join_child("validation", *children["validation"])
    log(json.dumps({"timings": child_run["timings"]}))
    window_run = join_child("window", *children["window"])
    log(json.dumps({"timings": window_run["timings"]}))
    paths["launches"].update(cli_run["launches"])
    paths["launches"].update(mesh_run["launches"])
    paths["launches"].update(ingest_run["launches"])
    paths["launches"].update(ckpt_run["launches"])
    paths["launches"].update(matrix_run["launches"])
    paths["launches"].update(fed_run["launches"])
    paths["launches"].update(cert_run["launches"])
    paths["launches"].update(ns_run["launches"])
    paths["launches"].update(child_run["launches"])
    paths["launches"].update(strat_run["launches"])
    paths["launches"].update(window_run["launches"])
    # launches on each main path, each counted from 0 just before it
    k1_paths = {"run_keys regfile": launches, **{
        p: n for p, n in paths["launches"].items() if "chunked" not in p}}
    k2_paths = {"outcomes_from_keys regfile": k2_record["launches"], **{
        p: n for p, n in paths["launches"].items() if "chunked" in p}}
    max_err = max(max_err, paths["k1_max_err"], cli_run["k1_max_err"],
                  mesh_run["k1_max_err"], ingest_run["k1_max_err"],
                  ckpt_run["k1_max_err"], matrix_run["k1_max_err"],
                  fed_run["k1_max_err"], cert_run["k1_max_err"],
                  ns_run["k1_max_err"], child_run["k1_max_err"],
                  strat_run["k1_max_err"], window_run["k1_max_err"])
    k2_err = max(k2_record["max_abs_err"], ingest_run["k2_max_err"],
                 window_run["k2_max_err"])
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
    if len(sys.argv) >= 4 and sys.argv[1] == "--child":
        sys.exit(child_main(*sys.argv[2:]))
    if len(sys.argv) >= 3 and sys.argv[1] == "--fed-cli":
        sys.exit(fed_cli_main(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
