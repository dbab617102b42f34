"""Journaled streaming ingest: binary in, campaign-ready plan out.

The reference drives campaigns straight from a workload binary (boot →
capture → fast-forward → measure); here the same flow is decomposed
into five resumable, WAL-journaled stages —

    capture   verify the stored binary's digest, resolve the
              kernel_begin/kernel_end markers, statically decode the
              ELF, and run the ptrace tracer; the raw capture becomes a
              durable store payload
    lift      macro→µop lift of the full capture with the lifter's
              register/branch self-check against the host capture (the
              oracle); a lift rate below the floor is divergence
    liveness  first-access liveness masks over the capture
    simpoint  BBV profile + k-means representative selection
    window    per-representative emulate→snapshot→run→lift, each window
              an independent unit lifted in parallel, with a boundary
              golden (start registers, pc, region digest) per window

— each writing into the content-digest-keyed ``ArtifactStore``
(``store.py``).  Stage completion is recorded in a per-tenant
write-ahead journal (``ingest_stage`` / ``ingest_done`` /
``ingest_quarantine`` — journaled BEFORE in-memory state is trusted,
GL201/GL202-certified) so a hard kill at any boundary resumes from the
last durable stage: replay restores the ledger, and every stage
re-verifies its store artifacts before being skipped, so a journal that
is AHEAD of a torn store payload simply re-runs the stage.

Poison vs damage: a store artifact that fails verification is a cache
MISS (recompute); a submitted binary whose bytes no longer hash to its
claimed digest, an unparseable ELF, a markerless workload, or lift
divergence vs the host oracle is POISON — the pipeline raises
``IngestQuarantine``, the journal records it durably, and the scheduler
parks the tenant in ``quarantined`` with the evidence doc instead of
retrying or taking the pod down.

Import discipline: the lifter, the emulator and the chunked engine enter
inside the stage functions, so the module stays light to import.
"""

from __future__ import annotations

import os
import subprocess

from shrewd_tpu_torch.ingest.store import ArtifactStore, axes_key
from shrewd_tpu_torch.obs import trace as obs_trace
from shrewd_tpu_torch.service.journal import FleetJournal
from shrewd_tpu_torch.utils import debug

#: the journaled stage order (the reference's boot→capture→fast-forward
#: flow, decomposed); a stage's index is its chaos ordinal
#: (``at_stage`` in ``corrupt_binary`` / ``kill_during_lift`` plans)
STAGES = ("capture", "lift", "liveness", "simpoint", "window")

WAL_NAME = "ingest.jsonl"

#: the ingest axes and their defaults — normalized before keying the
#: store, so ``{}`` and an explicit-defaults dict share artifacts
DEFAULT_AXES = {
    "interval": 2000,        # macro-ops per BBV interval
    "k": 3,                  # SimPoint clusters requested
    "max_steps": 200_000,    # capture macro-op budget
    "seed": 0,               # SimPoint k-means seed
    "min_lift_rate": 0.25,   # lift-divergence quarantine floor
    "max_workers": 4,        # parallel window lifts
    "preprocess": False,     # terminal chunk-preprocess stage (see below)
    "chunk": 65536,          # chunk length S for the preprocess stage
}


def normalize_axes(axes: dict | None) -> dict:
    axes = dict(axes or {})
    unknown = sorted(set(axes) - set(DEFAULT_AXES))
    if unknown:
        raise ValueError(f"unknown ingest axes {unknown} "
                         f"(one of {sorted(DEFAULT_AXES)})")
    out = dict(DEFAULT_AXES)
    out.update(axes)
    return out


class IngestQuarantine(RuntimeError):
    """A submission-is-poison verdict from an ingest stage: the binary,
    not the pod, is at fault — the scheduler quarantines immediately
    (no retry budget: a deterministic rejection cannot heal)."""

    def __init__(self, stage: str, reason: str):
        self.stage = stage
        self.reason = reason
        super().__init__(f"ingest {stage}: {reason}")


class IngestPipeline:
    """One tenant's journaled ingest run over a shared artifact store.

    ``outdir`` is the tenant's ``ingest/`` namespace (it rides tenant
    checkpoint copies, so gateway migration moves the WAL with the
    tenant); ``store`` is shared — across tenants, and across pods when
    the federation threads one ``store_dir`` through its schedulers."""

    def __init__(self, outdir: str, store: ArtifactStore, digest: str,
                 axes: dict | None = None, chaos=None):
        os.makedirs(outdir, exist_ok=True)
        self.outdir = outdir
        self.store = store
        self.digest = digest
        self.axes = normalize_axes(axes)
        self.key = axes_key(self.axes)
        self.chaos = chaos
        #: journaled ledger (mutated only via ``_apply_record``)
        self.stage_done: dict = {}
        self.plan_doc: dict | None = None
        self.quarantine_rec: dict | None = None
        #: work counters (the dedup/warm-start pins read these)
        self.captures = 0
        self.lifts = 0
        self._nt = None
        self._insts = None
        jp = os.path.join(outdir, WAL_NAME)
        records, torn, _valid = (FleetJournal.replay_path(jp)
                                 if os.path.exists(jp) else ([], 0, 0))
        self.journal = FleetJournal(jp)
        self.torn_dropped = torn
        for r in records:
            self._apply_record(r)

    # --- the WAL contract -------------------------------------------------

    def _jlog(self, kind: str, data: dict | None = None) -> None:
        """Journal-then-apply: the transition is durable before any
        in-memory ledger trusts it (GL201), and replay shares the exact
        mutation path (``_apply_record``, GL202)."""
        rec = {"kind": kind}
        if data:
            rec.update(data)
        self.journal.append(kind, data)
        self._apply_record(rec)

    def _apply_record(self, r: dict) -> None:
        kind = r.get("kind")
        if kind == "ingest_stage":
            self.stage_done[r["stage"]] = {
                "ordinal": int(r.get("ordinal", -1)),
                "cached": bool(r.get("cached", False))}
        elif kind == "ingest_done":
            self.plan_doc = dict(r.get("plan") or {})
        elif kind == "ingest_quarantine":
            self.quarantine_rec = {"stage": r.get("stage", ""),
                                   "error": r.get("error", "")}

    # --- verification helpers ---------------------------------------------

    def _check_binary(self, stage: str) -> None:
        """Every stage re-verifies the stored binary before touching it:
        rot between stages (chaos ``corrupt_binary``, real bit-rot) must
        quarantine AT the stage that would consume the bad bytes."""
        if not self.store.verify_binary(self.digest):
            raise IngestQuarantine(
                stage, f"stored binary no longer hashes to its claimed "
                       f"digest {self.digest[:12]} (rot or tamper)")

    def _chaos_gate(self, ordinal: int) -> None:
        if self.chaos is None:
            return
        from shrewd_tpu_torch import chaos as chaos_mod

        if self.chaos.take_corrupt_binary(ordinal) is not None:
            chaos_mod.rot_file(self.store.binary_path(self.digest))
        self.chaos.maybe_kill_during_lift(ordinal)

    def _stage_ok(self, stage: str) -> bool:
        """A stage is durably complete iff its store document (and every
        payload it vouches for) verifies — the journal alone is never
        enough, so a journal ahead of a torn store re-runs the stage."""
        return self.store.get_doc(self.digest, self.key, stage) is not None

    def _plan_probe(self) -> dict | None:
        """The O(1) warm start: a verified terminal ``plan`` document
        (its payload table covers every window trace)."""
        return self.store.get_doc(self.digest, self.key, "plan")

    def _stage_list(self) -> tuple:
        """The journaled stage order for THIS run's axes: the optional
        terminal ``preprocess`` stage (chunk-window preprocessing for the
        chunked replay engines) rides the same WAL/store certification as
        the five base stages — same ``ingest_stage`` journal kind, same
        doc-verified resume — so GL201/GL202 hold for it with no new
        record kinds."""
        if self.axes.get("preprocess"):
            return STAGES + ("preprocess",)
        return STAGES

    # --- the run loop -----------------------------------------------------

    def run(self) -> dict:
        """Execute (or resume, or warm-start) the pipeline; returns the
        terminal plan document.  Raises ``IngestQuarantine`` — durably
        journaled first — when the submission is poison."""
        if self.quarantine_rec is not None:
            # the poison verdict is durable: never re-run a quarantined
            # submission (the binary cannot have healed)
            raise IngestQuarantine(self.quarantine_rec["stage"],
                                   self.quarantine_rec["error"])
        if self.plan_doc is not None and self._plan_probe() is not None:
            return self.plan_doc
        probe = self._plan_probe()
        if probe is None:
            # single-flight: concurrent submissions of the same
            # (digest, axes) serialize here; the loser re-probes and
            # warm-starts from the winner's artifacts
            with self.store.lock(self.digest, self.key):
                probe = self._plan_probe()
                if probe is None:
                    self._run_stages()
                    return self.plan_doc
        # warm start — journal the cache hit so the tenant's WAL is
        # self-contained evidence of where its windows came from
        for ordinal, stage in enumerate(self._stage_list()):
            self._jlog("ingest_stage", {"stage": stage,
                                        "ordinal": ordinal,
                                        "cached": True})
        self._jlog("ingest_done", {"plan": probe})
        obs_trace.tracer().emit("ingest_warm_start", cat="ingest",
                                digest=self.digest[:12])
        debug.dprintf("Ingest", "warm start for %s (0 lifts)",
                      self.digest[:12])
        return self.plan_doc

    def _run_stages(self) -> None:
        try:
            for ordinal, stage in enumerate(self._stage_list()):
                if stage in self.stage_done and self._stage_ok(stage):
                    continue          # resumed past a durable stage
                cached = self._stage_ok(stage)
                if not cached:
                    self._chaos_gate(ordinal)
                    self._check_binary(stage)
                    getattr(self, "_stage_" + stage)()
                self._jlog("ingest_stage", {"stage": stage,
                                            "ordinal": ordinal,
                                            "cached": cached})
                obs_trace.tracer().emit("ingest_stage", cat="ingest",
                                        stage=stage, cached=cached)
            plan = self._build_plan_doc()
            self.store.put_doc(self.digest, self.key, "plan", plan)
            self._jlog("ingest_done", {"plan": plan})
        except IngestQuarantine as q:
            # the verdict is durable BEFORE it propagates: a recovery
            # after the kill replays straight back into quarantine
            self._jlog("ingest_quarantine", {"stage": q.stage,
                                             "error": str(q)})
            raise

    def resolved_plan(self, base_plan: dict) -> dict:
        """Merge the scenario axes of the submitted plan with the
        store-resident windows: the result is an ordinary pre-lifted
        ``CampaignPlan`` document (TraceFileSpec per window), which is
        exactly what makes binary-path tallies bit-identical to the
        plan-path ones."""
        if self.plan_doc is None:
            raise RuntimeError("ingest pipeline has not completed")
        plan = {k: v for k, v in dict(base_plan).items()
                if k != "simpoints"}
        plan["simpoints"] = [
            {"type": "TraceFileSpec", "name": e["name"],
             "path": self.store.payload_path(self.digest, self.key,
                                             e["file"])}
            for e in self.plan_doc["simpoints"]]
        return plan

    # --- stages -----------------------------------------------------------

    def _binary(self) -> str:
        return self.store.binary_path(self.digest)

    def _scratch(self, name: str) -> str:
        # every scratch name carries ".tmp." — pre-rename staging is
        # non-durable, and crash-point snapshots scrub on that marker
        return os.path.join(self.outdir, f"{os.getpid()}.{name}")

    def _load_capture(self):
        """Parse the durable capture once per process (stages share it);
        the artifact store remains the source of truth across crashes."""
        if self._nt is None:
            from shrewd_tpu_torch.ingest.lift import (read_nativetrace,
                                                static_decode)

            self._nt = read_nativetrace(
                self.store.payload_path(self.digest, self.key,
                                        "capture.bin"))
            self._insts = static_decode(self._binary())
        return self._nt, self._insts

    def _stage_capture(self) -> None:
        from shrewd_tpu_torch.ingest import hostdiff
        from shrewd_tpu_torch.ingest.lift import read_nativetrace, static_decode

        binary = self._binary()
        try:
            begin, end = hostdiff.elf_markers(binary)
        except ValueError as e:
            raise IngestQuarantine("capture", str(e))
        try:
            static_decode(binary)
        except Exception as e:  # noqa: BLE001 — an undecodable text
            # section is a property of the submission, not the pod
            raise IngestQuarantine("capture",
                                   f"static decode failed: {e}")
        tracer = hostdiff.build_tracer()
        scratch = self._scratch("capture.tmp.bin")
        try:
            subprocess.run(
                [str(tracer), scratch, f"{begin:x}", f"{end:x}",
                 str(int(self.axes["max_steps"])), binary],
                check=True, capture_output=True, text=True)
        except (OSError, subprocess.CalledProcessError) as e:
            tail = (getattr(e, "stderr", "") or str(e)).strip()[-200:]
            raise IngestQuarantine("capture", f"capture failed: {tail}")
        try:
            nt = read_nativetrace(scratch)
        except (OSError, ValueError) as e:
            raise IngestQuarantine("capture", f"bad capture: {e}")
        sha = self.store.commit_payload(scratch, self.digest, self.key,
                                        "capture.bin")
        self.store.put_doc(self.digest, self.key, "capture", {
            "begin": begin, "end": end,
            "steps": int(nt.steps.shape[0] - 1),
            "fs_base": int(nt.fs_base),
            "payloads": {"capture.bin": sha}})
        self.captures += 1

    def _stage_lift(self) -> None:
        from shrewd_tpu_torch.ingest.lift import lift
        from shrewd_tpu_torch.trace import format as tf

        nt, insts = self._load_capture()
        try:
            trace, meta = lift("<ingest>", self._binary(), nt=nt,
                               insts=insts)
        except Exception as e:  # noqa: BLE001 — the lifter rejecting a
            # capture is a verdict on the submission
            raise IngestQuarantine("lift", f"lift failed: {e}")
        rate = float(meta["stats"]["lift_rate"])
        floor = float(self.axes["min_lift_rate"])
        if rate < floor:
            raise IngestQuarantine(
                "lift", f"lift divergence vs host oracle: lift_rate "
                        f"{rate:.4f} < floor {floor}")
        tmp = self._scratch("full.tmp.npz")
        tf.save(tmp, trace, meta)
        sha = self.store.commit_payload(tmp, self.digest, self.key,
                                        "full.npz")
        self.store.put_doc(self.digest, self.key, "lift", {
            "uops": int(trace.n), "lift_rate": rate,
            "payloads": {"full.npz": sha}})
        self.lifts += 1

    def _stage_liveness(self) -> None:
        import numpy as np

        from shrewd_tpu_torch.ingest import liveness

        nt, insts = self._load_capture()
        lv = liveness.analyze(nt, insts)
        tmp = self._scratch("liveness.tmp.npz")
        np.savez_compressed(
            tmp, reg_live=np.asarray(lv.reg_live, dtype=bool),
            mem_live32=np.asarray(sorted(lv.mem_live32),
                                  dtype=np.uint64))
        sha = self.store.commit_payload(tmp, self.digest, self.key,
                                        "liveness.npz")
        self.store.put_doc(self.digest, self.key, "liveness", {
            "steps": int(lv.steps), "truncated": bool(lv.truncated),
            "unknown_insts": int(lv.unknown_insts),
            "live_words": len(lv.mem_live32),
            "payloads": {"liveness.npz": sha}})

    def _stage_simpoint(self) -> None:
        import numpy as np

        from shrewd_tpu_torch.ingest.simpoint import (bbv_profile,
                                                choose_simpoints)

        nt, _insts = self._load_capture()
        steps = nt.steps[:-1]
        profile = bbv_profile(steps[:, 16],
                              int(self.axes["interval"]))
        sps = choose_simpoints(profile, int(self.axes["k"]),
                               seed=int(self.axes["seed"]))
        tmp = self._scratch("clusters.tmp.npz")
        np.savez_compressed(tmp, intervals=sps.intervals,
                            weights=sps.weights, labels=sps.labels)
        sha = self.store.commit_payload(tmp, self.digest, self.key,
                                        "clusters.npz")
        self.store.put_doc(self.digest, self.key, "simpoint", {
            "interval": int(self.axes["interval"]),
            "k": int(self.axes["k"]), "seed": int(self.axes["seed"]),
            "n_intervals": int(len(sps.labels)),
            "intervals": [int(x) for x in sps.intervals],
            "weights": [float(x) for x in sps.weights],
            "payloads": {"clusters.npz": sha}})

    def _stage_window(self) -> None:
        from concurrent.futures import ThreadPoolExecutor

        import hashlib

        from shrewd_tpu_torch.ingest.emu import Emulator, StopEmu, elf_regions
        from shrewd_tpu_torch.ingest.lift import lift
        from shrewd_tpu_torch.trace import format as tf

        nt, insts = self._load_capture()
        sdoc = self.store.get_doc(self.digest, self.key, "simpoint")
        if sdoc is None:
            raise RuntimeError("window stage reached with no durable "
                               "simpoint artifact")
        binary = self._binary()
        interval = int(sdoc["interval"])
        steps = nt.steps[:-1]
        regions = [(v, d) for v, d in nt.regions]
        regions += elf_regions(binary)

        def _one(i: int, rep: int, weight: float):
            # each representative window is an independent unit: fresh
            # emulator, own snapshot, own lift — safe to run in parallel
            start = rep * interval
            length = min(interval, len(steps) - start)
            emu = Emulator(insts, nt.steps[0][:16], regions,
                           int(nt.steps[0][16]), fs_base=nt.fs_base)
            try:
                for _ in range(start):
                    emu.step()
            except StopEmu as e:
                raise IngestQuarantine(
                    "window", f"emulation to window {i} start failed: "
                              f"{e}")
            snap_regions = [(r.vaddr, bytes(r.buf))
                            for r in emu.regions]
            res = emu.run(length)
            trace, meta = lift(
                "<ingest>", binary,
                nt=res.nt._replace(regions=snap_regions), insts=insts)
            meta["simpoint_interval"] = rep
            meta["simpoint_weight"] = weight
            meta["simpoint_start_step"] = start
            tmp = self._scratch(f"win{i}.tmp.npz")
            tf.save(tmp, trace, meta)
            rh = hashlib.sha256()
            for vaddr, buf in snap_regions:
                rh.update(vaddr.to_bytes(8, "little"))
                rh.update(buf)
            golden = {"interval": rep, "weight": weight,
                      "start_step": start,
                      "start_regs": [int(x) for x in res.nt.steps[0][:16]],
                      "start_pc": int(res.nt.steps[0][16]),
                      "regions_sha256": rh.hexdigest(),
                      "uops": int(trace.n)}
            return i, tmp, golden

        reps = [(i, int(rep), float(w)) for i, (rep, w) in
                enumerate(zip(sdoc["intervals"], sdoc["weights"]))]
        with ThreadPoolExecutor(
                max_workers=max(1, int(self.axes["max_workers"]))) as ex:
            results = list(ex.map(lambda a: _one(*a), reps))
        payloads = {}
        sims = []
        for i, tmp, golden in results:
            fname = f"win{i}.npz"
            sha = self.store.commit_payload(tmp, self.digest, self.key,
                                            fname)
            payloads[fname] = sha
            self.store.put_doc(self.digest, self.key, f"win{i}",
                               {**golden, "payloads": {fname: sha}})
            sims.append({"name": f"sp{golden['interval']}",
                         "file": fname,
                         "interval": golden["interval"],
                         "weight": golden["weight"],
                         "start_step": golden["start_step"]})
            self.lifts += 1
        self.store.put_doc(self.digest, self.key, "window", {
            "simpoints": sims, "payloads": dict(payloads)})

    def _stage_preprocess(self) -> None:
        """Optional terminal stage (axes ``preprocess=True``): build the
        chunked engines' preprocessed window (ops/window.py — NOP-padded
        SoA chunk arrays + golden boundary states at chunk length
        ``axes['chunk']``) for every lifted window and persist it
        content-addressed under the WINDOW TRACE's digest.  Campaigns and
        federated pods then open it mmap'd in O(1) — zero lifts, zero
        re-preprocessing — with chunks materializing lazily as the wave
        loop touches them.  The stage document records each window's
        (trace digest, S) store address; the heavyweight array payloads
        live under the trace digest so two binaries lifting to the same
        window share one copy."""
        from shrewd_tpu_torch.ops.chunked import preprocess_window
        from shrewd_tpu_torch.ops.trial import TrialKernel
        from shrewd_tpu_torch.trace import format as tf

        wdoc = self.store.get_doc(self.digest, self.key, "window")
        if wdoc is None:
            raise RuntimeError("preprocess stage reached with no durable "
                               "window artifact")
        S = int(self.axes["chunk"])
        entries = []
        for e in wdoc["simpoints"]:
            path = self.store.payload_path(self.digest, self.key,
                                           e["file"])
            trace, _meta = tf.load(path)
            # host work only (padding + the C++ boundary pass): the
            # kernel lends its trace, so it is built on the CPU
            win = preprocess_window(TrialKernel(trace, device="cpu"), S,
                                    store=self.store)
            entries.append({"name": e["name"], "file": e["file"],
                            "trace_digest": win.trace_digest,
                            "S": int(win.S), "C": int(win.C),
                            "uops": int(win.n)})
        self.store.put_doc(self.digest, self.key, "preprocess", {
            "chunk": S, "windows": entries})

    def _build_plan_doc(self) -> dict:
        wdoc = self.store.get_doc(self.digest, self.key, "window")
        if wdoc is None:
            raise RuntimeError("plan build reached with no durable "
                               "window artifact")
        return {"digest": self.digest, "axes": dict(self.axes),
                "simpoints": list(wdoc["simpoints"]),
                "payloads": dict(wdoc["payloads"])}
