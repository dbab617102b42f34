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
6. timings with CUDA events (median of 5 after a warm-up; the host
   loops, row pass, dense re-run and ``run_keys``, median of 3, the last
   warmed by phase 5; K1's plain version once after it) beside the card's
   name and power limit; K1's bound two ways (the full body on every
   step from each landing, and the function's own need from the
   kernel's hit counts: the kernels line's) and its longest walk;
7. the chunked window — ``generate_trace(seed=16, n=131072, nphys=256,
   mem_words=4096, working_set_words=1024)`` as a ``TrialKernel`` on the
   card — preprocessed at S = 65536 (C = 2); its last boundary equals the
   C++ golden replay's final state;
8. the chunk kernel (K2) against its plain version on the same device
   tensors (sets, live-step counts and the five flags bitwise equal):
   (b) 2048 lanes of every fault kind with ``may_latch`` at a shadow
   coverage of 0.5, a third of them carried in with seeded sets and
   negative coordinates, on the NOP-padded last chunk of S = 15000 (C =
   9), so that some are detected; (c) the same through the K = 4 build,
   where some sets overflow; (d) the lanes of (b) on that chunk with one
   loud step, where some lanes stop;
9. the chunked main path, ``ChunkedCampaign(kernel, chunk=65536)
   .outcomes_from_keys(...512 keys..., "regfile")``, with K2's launch
   count zeroed just before it: one K2 launch per fast wave, no call of the
   plain version; then batch (a): each of the main path's K2 waves (the
   512 regfile lanes of ``trial_keys(campaign_key(163), 512)``, each on its
   landing chunk, with the lanes carried into chunk 1 and the null
   padding) against the plain version on its own inputs; gates (i) taint
   = exact engine on 64 keys of ``campaign_key(161)``, (ii) the 512
   outcomes = the serial C++ oracle, (iii) the 64 taint outcomes = the JAX
   reference's, pinned, (iv) taint = exact at S = 15000 with
   ``carry_horizon=2``, some lanes carried;
10. the chunked path's timings (median of 3 after a warm-up, phase 9's
    for ``outcomes_from_keys``): trials/s of
    ``outcomes_from_keys``, K2 on each of the main path's waves and its
    plain version (timed once, in (a)), the chunk record, the setup
    gathers, the exact fallback and the preprocessing; K2's bound over
    those waves (the function's own need, and the full body from each
    landing) and each wave's longest walk with its ns per step;
11. the structure path: the flagship window as a ``TrialKernel`` with
    ``O3Config(shadow_model="fupool")`` (SHREWD's shadow-FU pool under
    the scoreboard's schedule; its availability counters printed); for
    each of fu, rob, iq, lsq and latch, ``run_keys(trial_keys(
    campaign_key(0), 131072), s)`` with K1's launch count zeroed just
    before it: exactly one K1 launch and no call of its plain version,
    the tally sums to the batch, the first 1024 keys give the JAX
    reference's pinned tally, 2048 outcomes equal the serial C++
    oracle's under the kernel's coverage, and K1 equals its plain version
    bitwise on all 131072 lanes; then the call timed once and K1 on its
    lanes (median of 5);
12. the campaign loop: ``run_until_ci(ShardedCampaign(kernel, None, s,
    stratify=True), seed=0, simpoint_id=0, structure_id=k,
    batch_size=4096, target_halfwidth=0.01)`` for regfile and fu, K1's
    count zeroed before each: converged, one K1 launch per batch, the
    tallies, strata, trials, batches and interval equal the JAX
    reference's pins; then, untimed, one ``tally_batch`` of 512 fu keys
    through the ``chunked=`` route on the chunked window at chunk 65536
    (K2's count zeroed before it): one K2 launch per fast wave, no call of
    the plain chunk scan, the tally equals the C++ oracle's, and K2 equals
    its plain version on the route's first wave;
13. the campaign CLI, in-process (``shrewd_tpu_torch.main.main``): the
    flagship window saved with ``trace.format.save`` and a plan JSON
    (``TraceFileSpec``, regfile and fu, batch 4096, ``O3Config(
    shadow_model="fupool")``, stratified, integrity at its defaults);
    (a) ``run`` at target 0.01 gives the JAX reference's ``PIN_CI``, with
    the host syncs counted (``torch.cuda.set_sync_debug_mode``); (b) at
    target 0.005 ``run`` serial, ``--sync-every 4 --pipeline-depth 2`` and
    ``--until-ci`` each give ``PIN_CLI``, the until-CI run consuming the
    serial run's batches; (c) a serial run with ``checkpoint_every=1``
    drained after its third batch and finished by ``resume`` gives
    ``PIN_CLI`` too.  Every run: rc 0, every batch on the device tier,
    ``resilience.tier_trials`` 0 for cpu and oracle, the integrity
    counters clean, K1's launches exactly the batches plus two per canary
    run plus one per audited batch (told apart by their lane counts), no
    call of K1's plain version on card tensors; K1 held against its plain
    version on the first regfile and fu batch launch.

Batch (e) of phase 4 holds K1 against its plain version on the lanes the
structure path draws: 2048 each of fu, rob, iq, lsq and latch from the
port's own samplers, with wrong-path sentinels, pipeline bubbles and the
FU pool's coverage.

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
REPS = 5                        # phase 6: median of 5
REPS_HOST = 3                   # phase 6's host-driven loops (row pass,
                                # dense re-run, run_keys): seconds each
REPS_CHUNKED = 3                # phase 10: each run holds a 65536-step
                                # exact fallback of several seconds
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
CHUNK_WINDOW = dict(seed=16, n=131072, nphys=256, mem_words=4096,
                    working_set_words=1024)
CHUNK = 65536
CHUNK_SMALL = 15000             # a second chunking: C = 9, NOP-padded tail
N_CHUNK_KEYS = 512
CHUNK_SEED = 163
GATE_SEED = 161
N_GATE = 64
N_CHUNK_MIXED = 2048
# the JAX reference's taint-engine outcomes (0 masked, 1 sdc, 2 due,
# 3 detected) for trial_keys(campaign_key(161), 64) on that window at
# chunk 65536 (shrewd_tpu ChunkedCampaign on CPU;
# tests/test_torch_chunked.py recomputes it and holds it equal)
PIN_CHUNKED = ("00000000022200000200000200000000"
               "00000020000220200020000022000000")

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
    hz_fast = ChunkedCampaign(kernel, chunk=CHUNK_SMALL, carry_horizon=2,
                              engine="taint")
    hz_exact = ChunkedCampaign(kernel, chunk=CHUNK_SMALL, carry_horizon=2,
                               engine="exact")
    o_hf = hz_fast.outcomes_from_keys(gate_keys, "regfile")
    o_he = hz_exact.outcomes_from_keys(gate_keys, "regfile")
    if not np.array_equal(o_hf, o_he):
        fail(f"gate (iv): at S={CHUNK_SMALL}, horizon 2 the engines differ "
             f"on {int((o_hf != o_he).sum())}/{N_GATE} keys")
    if hz_fast.last_stats["carried"] < 1:
        fail(f"gate (iv): no lane was carried at S={CHUNK_SMALL}")
    if plain_calls[0]:
        fail("the gates called the plain chunk scan")
    log(f"gates: (i) taint == exact on {N_GATE} keys, (ii) "
        f"{N_CHUNK_KEYS} outcomes == C++ oracle, (iii) == JAX pin, (iv) "
        f"S={CHUNK_SMALL} horizon 2 taint == exact, "
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

    # phase 9's counted run was the warm-up
    del exact_log[:]
    e2e_ms = time_ms(torch, lambda: camp.outcomes_from_keys(keys, "regfile"),
                     REPS_CHUNKED, warm=False)
    # the exact fallback inside each timed run (none: 0 lanes, 0 ms)
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
    from shrewd_tpu_torch.ops import chunked as CH
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
        t0 = time.monotonic()
        kernel.run_keys(keys, s)
        torch.cuda.synchronize()
        run_ms = (time.monotonic() - t0) * 1e3
        k1_ms = time_ms(torch, lambda: taint_fast_cuda(
            *args, **kw, stream=kernel.packed_stream))
        if plain_calls[0]:
            fail(f"{s}: the timed run called K1's plain version")
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
            f"{N_KEYS / (run_ms / 1e3):,.0f} trials/s, K1 {k1_ms:.3f} ms "
            f"({card}; first run {t_main:.1f} s, {escapes} escaped lanes "
            f"resolved)")
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
    # as phase 9: the exact fallback's waves counted apart, every K2
    # launch kept, and the plain chunk scan counted
    exact_waves = [0]
    run_exact = camp._outcomes_exact

    def counted_exact(f_host, outcomes, land_chunk, st):
        w0 = st["waves"]
        run_exact(f_host, outcomes, land_chunk, st)
        exact_waves[0] += st["waves"] - w0

    fu_waves: list = []

    def kept_launch(*a, **kw):
        got = taint_chunk_cuda(*a, **kw)
        fu_waves.append((a, kw, got))
        return got

    chunk_plain = [0]

    def counted_chunk_plain(*a, **kw):
        chunk_plain[0] += 1
        return taint_chunk(*a, **kw)

    camp._outcomes_exact = counted_exact
    CH.taint_chunk_cuda = kept_launch
    taint_cuda.taint_chunk = counted_chunk_plain
    taint_chunk_cuda.launches = 0
    t0 = time.monotonic()
    tally = ShardedCampaign(k16, None, "fu", chunked=camp).tally_batch(
        keys16).tolist()
    torch.cuda.synchronize()
    t_route = time.monotonic() - t0
    n_launch = taint_chunk_cuda.launches
    CH.taint_chunk_cuda = taint_chunk_cuda
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
    # K2 against its plain version on the route's first wave (a plain
    # 65536-step wave takes 65-95 s, so one of them)
    a, kw, got = fu_waves[0]
    t0 = time.monotonic()
    ref = taint_chunk(*a, **{x: v for x, v in kw.items() if x != "stream"})
    k2_err = compare_chunk(torch, got, ref, "chunked route fu wave 0")
    t_plain = time.monotonic() - t0
    launches["chunked tally_batch fu"] = n_launch
    timings["chunked_fu"] = {"tally": tally, "stats": camp.last_stats,
                             "kernel_build_s": t_build,
                             "wave0_plain_s": t_plain}
    log(f"chunked route: tally_batch({N_CHUNK_FU} fu keys) at S={CHUNK} "
        f"tally {tally} == C++ oracle, {n_launch} K2 launch(es) for "
        f"{fast_waves} fast waves, 0 plain calls, stats {camp.last_stats}; "
        f"K2 == plain on wave 0 ({a[3].kind.shape[0]} lanes, "
        f"{int(got[6].sum())} escaped; plain {t_plain:.1f} s); fupool "
        f"kernel on {trace16.n} µops built in {t_build:.1f} s, route "
        f"{t_route:.1f} s")
    marks("12 campaign loop")
    return {"timings": timings, "launches": launches,
            "k1_max_err": max_err, "k2_max_err": k2_err}

def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cli_phase(torch, marks, card) -> dict:
    """Phase 13, the campaign CLI on the flagship window → the timings,
    K1's launches on each run and K1's largest difference from its plain
    version on the runs' own batches."""
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
    pins01 = {s: {k: PIN_CI[s][k] for k in ("tallies", "trials", "batches",
                                             "strata")}
              for s in ("regfile", "fu")}
    plan01 = plan_file("plan01.json", CI_TARGET)
    plan005 = plan_file("plan005.json", CLI_TARGET)
    # (a) target 0.01, the host syncs counted
    a = run("(a) serial 0.01", ["run", plan01, "--outdir",
                                os.path.join(d, "a")], pins01, syncs=True)
    # (b) target 0.005, three ways
    serial = run("(b) serial", ["run", plan005, "--outdir",
                                os.path.join(d, "b0")], PIN_CLI)
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
    seen = 0
    for ev, _ in orch.events():
        if ev.name == "BATCH_COMPLETE":
            seen += 1
            if seen == 3:
                orch.request_drain()
        if ev.name == "PREEMPTED":
            break
    if not orch.preempted or seen != 3:
        fail(f"(c): the run did not stop after its third batch ({seen})")
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
        "run_a": a["host_syncs"], "run_a_batches": a["batches"],
        "per_batch_all_layers": a["host_syncs"] / a["batches"],
        "bare_batch_step": step_syncs}
    timings["cli_phase_s"] = time.monotonic() - t_phase
    log(f"host syncs: {a['host_syncs']} in run (a) = "
        f"{a['host_syncs'] / a['batches']:.1f} per batch with canaries, "
        f"audit and checks; {step_syncs} in one bare batch step "
        f"(tally_on_device)")
    log(f"perf: sync-every 4 {sync['perf']}; until-CI {until['perf']}")
    shutil.rmtree(d, ignore_errors=True)
    log(f"(c): stopped after 3 batches ({first} K1 launches), resumed to "
        f"the pins; K1 == plain on the regfile and fu batch launches; "
        f"phase 13 {timings['cli_phase_s']:.1f} s ({card})")
    launches["campaign CLI (c) resume"] = resumed["k1_launches"]
    marks("13 campaign CLI")
    return {"timings": timings, "launches": launches, "k1_max_err": max_err}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from shrewd_tpu_torch import native
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
    plain_ms = time_ms(torch, lambda: taint_fast_plain(*args, **kw), 1)
    rec_ms = time_ms(torch, lambda: record_golden(
        kernel.tr, kernel.init_reg, kernel.init_mem, True, True))
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
                     REPS_HOST)
    dense_ms = time_ms(torch, lambda: kernel.run_batch(dense_lanes),
                       REPS_HOST)
    e2e_ms = time_ms(torch, lambda: kernel.run_keys(keys, "regfile"),
                     REPS_HOST, warm=False)

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
    paths = structure_phases(torch, dev, marks, kernel_s, keys, card)
    log(json.dumps({"timings": paths["timings"]}))
    del kernel_s
    cli_run = cli_phase(torch, marks, card)
    log(json.dumps({"timings": cli_run["timings"]}))
    paths["launches"].update(cli_run["launches"])
    # launches on each main path, each counted from 0 just before it
    k1_paths = {"run_keys regfile": launches, **{
        p: n for p, n in paths["launches"].items() if "chunked" not in p}}
    k2_paths = {"outcomes_from_keys regfile": k2_record["launches"], **{
        p: n for p, n in paths["launches"].items() if "chunked" in p}}
    max_err = max(max_err, paths["k1_max_err"], cli_run["k1_max_err"])
    k2_err = max(k2_record["max_abs_err"], paths["k2_max_err"])
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
    sys.exit(main())
