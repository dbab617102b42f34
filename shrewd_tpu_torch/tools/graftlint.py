"""graftlint — determinism & replay-safety certification CLI of the port
(the port of the JAX package's ``tools/graftlint.py``, with its flags and
exit codes), run as ``python -m shrewd_tpu_torch.tools.graftlint``.

Two layers (shrewd_tpu_torch/analysis/):

- **AST lint** (always): repo-specific passes over ``shrewd_tpu_torch/`` —
  kernel-registry routing and no compiled steps (GL101), no wall clock in
  deterministic chaos/elastic regions (GL102), atomic checkpoint writes
  (GL103), PRNG key hygiene (GL104/GL105), the clock seam (GL106).  Rule
  scoping and severity come from ``shrewd_tpu_torch/analysis/
  graftlint.toml``; findings are waived in-source with
  ``# graftlint: allow-<rule> -- <reason>``.
- **step audit** (skippable with ``--no-jaxpr``, the reference's flag
  name): build the standard campaign steps (dense / hybrid / stratified
  per-batch steps, their interval and until-CI steps) over a probe window,
  run each once under the step auditor on the card (``--platform cpu``:
  the CPU) and certify the replay-safety rules — frozen-key RNG lineage,
  no hidden host reads, ONE device→host result copy per invocation, no
  undeclared in-place writes — and prove the auditor has teeth by
  rejecting two seeded-violation fixtures.  On the card each certificate
  also carries torch's own count of synchronizing calls over the same
  call (``sync_debug``) beside the auditor's census (``syncs``).

The AST layer includes the GL2xx crash/replay-safety family
(``analysis/replay_lint.py``): journal-before-mutate dominance,
journal-record-kind exhaustiveness, fsync-before-rename ordering and
best-effort-seam guards.  On top:

- ``--audit-waivers`` additionally FAILS on stale waivers (GL205) —
  waiver comments whose rule no longer fires at that site — so the
  reasoned-waiver ledger cannot rot;
- ``--sarif OUT`` exports findings as SARIF 2.1.0 so CI renders them
  as annotations instead of log greps;
- ``--crashcheck`` runs the bounded dynamic model checker
  (``analysis/crashcheck.py``): a small real fleet under the
  instrumented VFS shim, then exhaustive ``recover()`` re-execution
  from EVERY durability boundary (+ torn-append variants), asserting
  bit-identical final tallies at each; ``--crash-json`` records the
  artifact.

Exit status: 0 = clean (or only waived/baseline findings), 1 = new
violations (or a standard executable failed certification / the
violation fixture was NOT rejected / stale waivers under
``--audit-waivers`` / a crash point failed under ``--crashcheck``),
2 = usage/environment error.

Usage (nothing is written unless ``--json``/``--sarif``/``--crash-json``
ask)::

    python -m shrewd_tpu_torch.tools.graftlint --strict --audit-waivers \
        --json lint.json --sarif lint.sarif               # the gate
    python -m shrewd_tpu_torch.tools.graftlint --no-jaxpr  # AST only
    python -m shrewd_tpu_torch.tools.graftlint --platform cpu
    python -m shrewd_tpu_torch.tools.graftlint --no-jaxpr --crashcheck \
        --crash-json crash.json                           # the crash gate
    python -m shrewd_tpu_torch.tools.graftlint --baseline lint.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

#: the checkout holding the package: shrewd_tpu_torch/tools/ → the root
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _violation_key(v: dict) -> tuple:
    # path + rule + message identifies a finding across runs; LINE does
    # not participate (pre-existing findings must not become "new" when
    # unrelated edits shift them)
    return (v["path"], v["rule"], v["msg"])


_SARIF_LEVELS = {"error": "error", "warn": "warning"}


def to_sarif(doc: dict) -> dict:
    """SARIF 2.1.0 over the lint artifact: violations (error), warnings
    (warning) and stale waivers (error) — waived findings stay out (they
    are ledger, not actionable)."""
    from shrewd_tpu_torch.analysis import RULES

    results = []
    for group, level in (("violations", None), ("warnings", None),
                         ("stale_waivers", "error")):
        for v in doc.get(group, []):
            results.append({
                "ruleId": v["rule"],
                "level": level or _SARIF_LEVELS.get(
                    v.get("severity", "error"), "error"),
                "message": {"text": v["msg"]},
                "locations": [{"physicalLocation": {
                    "artifactLocation": {"uri": v["path"]},
                    "region": {"startLine": max(1, int(v["line"]))}}}],
            })
    return {
        "version": "2.1.0",
        "$schema": "https://raw.githubusercontent.com/oasis-tcs/"
                   "sarif-spec/master/Schemata/sarif-schema-2.1.0.json",
        "runs": [{
            "tool": {"driver": {
                "name": "graftlint",
                "informationUri":
                    "shrewd_tpu_torch/analysis/ (ast_lint + replay_lint)",
                "rules": [{"id": rid, "name": name,
                           "shortDescription": {"text": name}}
                          for rid, name in sorted(RULES.items())],
            }},
            "results": results,
        }],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="graftlint", description=__doc__.splitlines()[0])
    ap.add_argument("--strict", action="store_true",
                    help="record the strict posture in the JSON artifact "
                         "(violations always gate the exit code; "
                         "--baseline is the one escape hatch)")
    ap.add_argument("--baseline", default=None, metavar="LINT.json",
                    help="previous lint artifact: only violations NOT in "
                         "it are fatal (pre-existing findings report but "
                         "don't gate)")
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="write the machine-readable lint artifact")
    ap.add_argument("--no-jaxpr", action="store_true",
                    help="skip the campaign-step audit (fast AST-only "
                         "mode; the reference's flag name)")
    ap.add_argument("--audit-waivers", action="store_true",
                    help="fail on STALE waivers (GL205): waiver "
                         "comments whose rule no longer fires at that "
                         "site — the reasoned-waiver ledger must not "
                         "rot")
    ap.add_argument("--sarif", default=None, metavar="OUT",
                    help="export findings as SARIF 2.1.0 (CI "
                         "annotations instead of log greps)")
    ap.add_argument("--crashcheck", action="store_true",
                    help="run the bounded dynamic crash-point model "
                         "checker (analysis/crashcheck.py): exhaustive "
                         "recover() re-execution from every durability "
                         "boundary of a small real fleet")
    ap.add_argument("--crash-json", default=None, metavar="OUT",
                    help="write the crashcheck artifact")
    ap.add_argument("--gateway-crashcheck", action="store_true",
                    help="also sweep the federation GATEWAY's WAL "
                         "(analysis/crashcheck.py run_gateway_crashcheck)"
                         ": recover a 2-pod federation from every "
                         "gateway durability boundary — the "
                         "route-decision-vs-pod-handoff window must "
                         "replay, never double-place a tenant")
    ap.add_argument("--gateway-crash-json", default=None, metavar="OUT",
                    help="write the gateway sweep artifact")
    ap.add_argument("--root", default=REPO_ROOT,
                    help="repo root (default: the checkout this package "
                         "lives in)")
    ap.add_argument("--platform", default=None,
                    help="cpu runs the step audit and the crash sweeps "
                         "on the CPU; the default (or gpu) is the card")
    args = ap.parse_args(argv)
    if args.platform not in (None, "", "gpu", "cuda", "cpu"):
        print(f"graftlint: unknown --platform {args.platform!r} "
              "(cpu | gpu)", file=sys.stderr)
        return 2
    on_cpu = args.platform == "cpu"

    from shrewd_tpu_torch.analysis import lint_tree, load_config

    try:
        cfg = load_config(args.root)
    except ValueError as e:
        print(f"graftlint: {e}", file=sys.stderr)
        return 2
    report = lint_tree(args.root, cfg)

    doc = {
        "tool": "graftlint",
        "strict": bool(args.strict),
        "transfer_budget": cfg.transfer_budget,
        **report.to_dict(),
    }

    certify_ok = True
    if not args.no_jaxpr:
        from shrewd_tpu_torch.analysis.certify import \
            certify_standard_executables

        cert_doc = certify_standard_executables(
            transfer_budget=cfg.transfer_budget,
            device="cpu" if on_cpu else None, sync_debug=not on_cpu)
        doc["executables"] = cert_doc
        certify_ok = cert_doc["ok"]

    def mesh():
        if not on_cpu:
            return None
        from shrewd_tpu_torch.parallel.mesh import make_mesh

        return make_mesh(["cpu"])

    crash_ok = True
    if args.crashcheck:
        import shutil
        import tempfile

        from shrewd_tpu_torch.analysis.crashcheck import run_crashcheck

        workdir = tempfile.mkdtemp(prefix="crashcheck_")
        try:
            crash_doc = run_crashcheck(workdir, mesh=mesh())
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        crash_ok = crash_doc["ok"]
        doc["crashcheck"] = {k: crash_doc[k] for k in (
            "points", "checks", "torn_checks", "boundaries_by_event",
            "seq_monotonic", "ok")}
        if args.crash_json:
            with open(args.crash_json, "w") as f:
                json.dump(crash_doc, f, indent=1)
                f.write("\n")
            print(f"wrote {args.crash_json}")

    if args.gateway_crashcheck:
        import shutil
        import tempfile

        from shrewd_tpu_torch.analysis.crashcheck import \
            run_gateway_crashcheck

        workdir = tempfile.mkdtemp(prefix="gwcrash_")
        try:
            gw_doc = run_gateway_crashcheck(workdir, mesh=mesh())
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        crash_ok = crash_ok and gw_doc["ok"]
        doc["gateway_crashcheck"] = {k: gw_doc[k] for k in (
            "points", "checks", "torn_checks", "boundaries_by_event",
            "ok")}
        if args.gateway_crash_json:
            with open(args.gateway_crash_json, "w") as f:
                json.dump(gw_doc, f, indent=1)
                f.write("\n")
            print(f"wrote {args.gateway_crash_json}")

    new_violations = [f.to_dict() for f in report.violations]
    if args.baseline and os.path.exists(args.baseline):
        with open(args.baseline) as f:
            base = {_violation_key(v)
                    for v in json.load(f).get("violations", [])}
        new_violations = [v for v in new_violations
                         if _violation_key(v) not in base]
    stale_gate = bool(report.stale) and args.audit_waivers
    doc["new_violations"] = new_violations
    doc["ok"] = certify_ok and crash_ok and not new_violations \
        and not stale_gate

    # --- human-readable report ---
    for f in report.violations:
        print(f"VIOLATION {f}")
    for f in report.warnings:
        print(f"warning   {f}")
    for f in report.stale:
        tag = "STALE" if args.audit_waivers else "stale"
        print(f"{tag}     {f}")
    for f in report.waivers:
        print(f"waived    {f.path}:{f.line} {f.rule} -- {f.waiver_reason}")
    if not args.no_jaxpr:
        ex = doc["executables"]
        for name, c in sorted(ex["certificates"].items()):
            verdict = "certified" if c["ok"] else "REJECTED"
            torch_n = (f", torch counted {c['sync_debug']}"
                       if "sync_debug" in c else "")
            print(f"executable {name}: {verdict} "
                  f"(transfers={c['transfers']}/"
                  f"{ex['transfer_budget']}, syncs="
                  f"{sum(c['syncs'].values())}{torch_n})")
        for key, label in (("fixture_rejected", "violation fixture"),
                           ("until_ci_fixture_rejected",
                            "until-CI violation fixture")):
            print(f"{label}: "
                  + ("rejected (auditor has teeth)" if ex[key]
                     else "NOT REJECTED — the auditor is blind"))
    if args.crashcheck:
        cc = doc["crashcheck"]
        print(f"crashcheck: {cc['checks']} recoveries from "
              f"{cc['points']} crash points ({cc['torn_checks']} torn) "
              f"-> {'bit-identical at every one' if cc['ok'] else 'FAILED'}")
    if args.gateway_crashcheck:
        gc = doc["gateway_crashcheck"]
        print(f"gateway crashcheck: {gc['checks']} federation "
              f"recoveries from {gc['points']} gateway boundaries "
              f"({gc['torn_checks']} torn) -> "
              + ("bit-identical, every tenant placed once"
                 if gc["ok"] else "FAILED"))
    n_v, n_w = len(report.violations), len(report.waivers)
    print(f"graftlint: {n_v} violation(s) "
          f"({len(new_violations)} new), {len(report.warnings)} "
          f"warning(s), {n_w} waiver(s), {len(report.stale)} stale"
          + ("" if args.no_jaxpr else
             f", executables {'ok' if certify_ok else 'FAILED'}"))

    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        print(f"wrote {args.json}")
    if args.sarif:
        with open(args.sarif, "w") as f:
            json.dump(to_sarif(doc), f, indent=1)
            f.write("\n")
        print(f"wrote {args.sarif}")

    # violations gate unconditionally; --baseline is the one escape hatch
    # (it already filtered new_violations above) and --strict only names
    # the posture in the artifact
    return 1 if (new_violations or not certify_ok or not crash_ok
                 or stale_gate) else 0


if __name__ == "__main__":
    sys.exit(main())
