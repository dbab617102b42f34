"""The port's linters (``shrewd_tpu_torch/analysis/ast_lint.py`` and
``replay_lint.py``) and ``python -m shrewd_tpu_torch.tools.graftlint``.

GL102, GL103, GL106 and GL201-GL205 are the reference's passes: the same
fixture sources, linted by both packages at the same place in their trees
under their default scoping, give the same findings (rule, line, message).
GL101, GL104 and GL105 are re-scoped to the port (kernel-registry routing,
``prng.split``, key genesis) and have fixtures of their own.  The port's
tree lints clean under ``graftlint.toml`` with reasoned waivers and no
stale one, and its journal kinds are exhaustive."""

import json
import os
import textwrap

import pytest

from shrewd_tpu.analysis import GraftlintConfig as RefConfig
from shrewd_tpu.analysis import ast_lint as ref_lint
from shrewd_tpu.analysis import replay_lint as ref_replay
from shrewd_tpu_torch.analysis import (GraftlintConfig, ast_lint, lint_tree,
                                       load_config, replay_lint)
from shrewd_tpu_torch.tools import graftlint as graftlint_cli

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (id, path under the package, source) — linted by both packages
SHARED = [
    ("gl102-wall-clock", "chaos.py", """
        import time
        def should_fire(batch_id):
            return time.time() % 2 < 1
        def wedge():
            time.sleep(0.1)
        def ledger():
            return time.monotonic()
    """),
    ("gl103-raw-write", "campaign/orchestrator.py", """
        import json
        def save(doc, path):
            with open(path, "w") as f:
                json.dump(doc, f)
        def write_json_atomic(path, doc):
            with open(path + ".tmp", "w") as f:
                json.dump(doc, f)
    """),
    ("gl106-clock", "obs/metrics.py", """
        import time
        def stamp():
            return time.perf_counter(), time.monotonic_ns()
    """),
    ("gl201-journal-before-mutate", "service/scheduler.py", """
        class S:
            def finish(self, t):
                t.status = "complete"
                self._jlog("status", {"status": t.status})
            def good(self, t, rc):
                status = "aborted" if rc else "complete"
                self._jlog("status", {"status": status})
                t.status = status
            def branchy(self, t, loud):
                if loud:
                    self._jlog("status", {})
                t.status = "complete"
            def _apply_record(self, t, r):
                t.status = r["status"]
    """),
    ("gl201-waivers", "service/scheduler.py", """
        class S:
            def fixup(self, t):
                # graftlint: allow-journal-before-mutate -- fixture:
                # in-memory scratch copy, never journaled
                t.status = "x"
            def bare(self, t):
                # graftlint: allow-journal-before-mutate
                t.trials = 0
    """),
    ("gl203-fsync-rename", "service/journal.py", """
        import os
        def compact(path):
            with open(path + ".tmp", "w") as f:
                f.write("")
            os.replace(path + ".tmp", path)
        def synced(path):
            with open(path + ".tmp", "w") as f:
                f.flush()
                os.fsync(f.fileno())
            os.replace(path + ".tmp", path)
        def branchy(path, sync):
            if sync:
                os.fsync(0)
            os.rename(path + ".tmp", path)
    """),
    ("gl203-recovery-read", "service/scheduler.py", """
        import json, os
        def recover(outdir):
            with open(os.path.join(outdir, "fleet.json")) as f:
                return json.load(f)
        def save(outdir, doc):
            with open(os.path.join(outdir, "fleet.json"), "w") as f:
                f.write("x")
        def notes(outdir):
            with open(os.path.join(outdir, "notes.txt"), "w") as f:
                f.write("x")
    """),
    ("gl204-best-effort", "service/scheduler.py", """
        from somewhere import obs_trace
        def quarantine(outdir):
            obs_trace.flight_dump(outdir, "why")
        def guarded(outdir):
            try:
                obs_trace.flight_dump(outdir, "why")
            except Exception:
                pass
        def narrow(outdir):
            try:
                obs_trace.flight_dump(outdir, "why")
            except OSError:
                pass
    """),
]

#: (id, path under the package, source) — tree passes: GL202 and GL205
SHARED_TREE = [
    ("gl202-orphan-and-ghost", "service/scheduler.py", """
        class S:
            def act(self):
                self._jlog("admit", {})
                self._jlog("orphan", {})

            def _apply_record(self, r):
                kind = r.get("kind")
                if kind in ("admit", "ghost"):
                    return
    """),
    ("gl205-stale", "service/scheduler.py", """
        import time
        class S:
            def _apply_record(self, r):
                # graftlint: allow-wall-clock -- fixture: a LIVE waiver
                x = time.time()
                # graftlint: allow-raw-write -- fixture: STALE
                plain = 1
    """),
]


def _norm(findings, pkg):
    return [(f.rule, f.line, f.msg.replace(pkg + "/", "PKG/"), f.waived,
             f.waiver_reason, f.severity) for f in findings]


def _write(root, pkg, rel, src):
    path = os.path.join(root, pkg, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    for d in (os.path.join(root, pkg),
              os.path.dirname(path)):
        open(os.path.join(d, "__init__.py"), "a").close()
    with open(path, "w") as f:
        f.write(textwrap.dedent(src))
    return path


@pytest.mark.parametrize("fid,rel,src", SHARED, ids=[s[0] for s in SHARED])
def test_shared_rules_match_the_reference(tmp_path, fid, rel, src):
    got = {}
    for pkg, lint, cfg in (("shrewd_tpu", ref_lint, RefConfig()),
                           ("shrewd_tpu_torch", ast_lint,
                            GraftlintConfig())):
        path = _write(str(tmp_path), pkg, rel, src)
        got[pkg] = _norm(lint.lint_file(path, f"{pkg}/{rel}", cfg), pkg)
    assert got["shrewd_tpu_torch"] == got["shrewd_tpu"]
    assert got["shrewd_tpu"], fid            # every fixture fires


@pytest.mark.parametrize("fid,rel,src", SHARED_TREE,
                         ids=[s[0] for s in SHARED_TREE])
def test_shared_tree_passes_match_the_reference(tmp_path, fid, rel, src):
    got = {}
    for pkg, lint, cfg in (("shrewd_tpu", ref_lint, RefConfig()),
                           ("shrewd_tpu_torch", ast_lint,
                            GraftlintConfig())):
        _write(str(tmp_path), pkg, rel, src)
        rep = lint.lint_tree(str(tmp_path), cfg, package=pkg)
        got[pkg] = (_norm(rep.findings, pkg), _norm(rep.stale, pkg))
    assert got["shrewd_tpu_torch"] == got["shrewd_tpu"]
    findings, stale = got["shrewd_tpu"]
    if fid.startswith("gl202"):
        assert [(r, s) for r, _, _, _, _, s in findings] == [
            ("GL202", "error"), ("GL202", "warn")]
    else:
        assert [r for r, *_ in stale] == ["GL205"]


# --- the port's own rules -----------------------------------------------------

def _lint_src(tmp_path, src, rel="shrewd_tpu_torch/parallel/campaign.py",
              cfg=None):
    path = tmp_path / "fixture.py"
    path.write_text(textwrap.dedent(src))
    return ast_lint.lint_file(str(path), rel, cfg or GraftlintConfig())


def _rules(findings, waived=False):
    return sorted({f.rule for f in findings if f.waived == waived})


def test_gl101_kernel_registry_positive_and_negative(tmp_path):
    bad = _lint_src(tmp_path, """
        from shrewd_tpu_torch.ops.trial import TrialKernel
        def kernel_for(trace, cfg):
            return TrialKernel(trace, cfg, device="cpu")
    """)
    assert _rules(bad) == ["GL101"]
    routed = _lint_src(tmp_path, """
        from shrewd_tpu_torch.ops.trial import TrialKernel
        from shrewd_tpu_torch.parallel import exec_cache
        def kernel_for(trace, cfg, fp):
            return exec_cache.shared_kernel(
                trace, fp, lambda: TrialKernel(trace, cfg))
        def build_kernel(trace, cfg):
            return TrialKernel(trace, cfg)
    """)
    assert _rules(routed) == []
    compiled = _lint_src(tmp_path, """
        import torch
        step = torch.compile(lambda x: x)
        @torch.compile
        def fused(x):
            return x
        traced = torch.jit.script(fused)
    """)
    assert [f.rule for f in compiled] == ["GL101"] * 3
    # out of scope: a module GL101 does not cover
    off = _lint_src(tmp_path, """
        from shrewd_tpu_torch.ops.trial import TrialKernel
        k = TrialKernel(None)
    """, rel="shrewd_tpu_torch/analysis/certify.py")
    assert _rules(off) == []


def test_gl104_key_reuse_positive_and_negative(tmp_path):
    bad = _lint_src(tmp_path, """
        from shrewd_tpu_torch.utils import prng
        def draw(key):
            a, b = prng.split(key)
            return prng.uniform(key, (4,))
    """)
    assert _rules(bad) == ["GL104"]
    assert "prng.split" in bad[0].msg
    good = _lint_src(tmp_path, """
        from shrewd_tpu_torch.utils import prng
        def draw(key, i):
            k1 = prng.fold_in(key, 1)
            k2 = prng.fold_in(key, 2)
            key = prng.split(key)
            return prng.uniform(k1, (4,)), prng.uniform(k2, (4,))
    """)
    assert _rules(good) == []


def test_gl105_key_genesis_positive_and_negative(tmp_path):
    bad = _lint_src(tmp_path, """
        import torch
        from shrewd_tpu_torch.utils import prng
        key = prng.threefry_seed(7)
        g = torch.Generator()
        torch.manual_seed(0)
    """)
    assert [f.rule for f in bad] == ["GL105"] * 3
    allowed = _lint_src(tmp_path, """
        def campaign_key(seed):
            return threefry_seed(seed)
    """, rel="shrewd_tpu_torch/utils/prng.py")
    assert _rules(allowed) == []
    derived = _lint_src(tmp_path, """
        from shrewd_tpu_torch.utils import prng
        key = prng.campaign_key(7, "cpu")
    """)
    assert _rules(derived) == []


def test_waiver_covers_but_only_with_reason(tmp_path):
    src = """
        from shrewd_tpu_torch.ops.trial import TrialKernel
        # graftlint: allow-jit -- fixture: a one-off kernel
        a = TrialKernel(None)
        # graftlint: allow-jit
        b = TrialKernel(None)
    """
    got = _lint_src(tmp_path, src)
    assert [(f.rule, f.waived) for f in got] == [("GL101", True),
                                                 ("GL101", False)]
    assert got[0].waiver_reason == "fixture: a one-off kernel"
    assert "missing its reason" in got[1].msg


@pytest.mark.parametrize("level", ["warn", "off"])
def test_severity_warn_and_off(tmp_path, level):
    cfg = GraftlintConfig()
    cfg.severity["GL105"] = level
    got = _lint_src(tmp_path, """
        import torch
        g = torch.Generator()
    """, cfg=cfg)
    if level == "off":
        assert got == []
    else:
        assert [(f.rule, f.severity) for f in got] == [("GL105", "warn")]


# --- the port's own tree ------------------------------------------------------

def test_port_config_parses_and_maps_the_reference_posture():
    cfg = load_config(REPO_ROOT)
    ref = ref_lint  # noqa: F841 — the posture's source of truth below
    from shrewd_tpu.analysis import load_config as ref_load

    rcfg = ref_load(REPO_ROOT)
    for key in ("deterministic_modules", "checkpoint_modules",
                "clock_modules", "journaled_modules", "durability_modules",
                "best_effort_modules"):
        assert getattr(cfg, key) == [
            p.replace("shrewd_tpu/", "shrewd_tpu_torch/")
            for p in getattr(rcfg, key)], key
    assert cfg.journaled_modules == [
        "shrewd_tpu_torch/service/scheduler.py",
        "shrewd_tpu_torch/scenario/runner.py",
        "shrewd_tpu_torch/federation/gateway.py",
        "shrewd_tpu_torch/ingest/pipeline.py"]
    assert "shrewd_tpu_torch/ops/taint_cuda.py" in cfg.jit_modules
    assert cfg.journaled_attrs == rcfg.journaled_attrs
    assert cfg.severity == rcfg.severity
    assert cfg.transfer_budget == 1
    for key in ("jit_modules", "deterministic_modules", "clock_modules",
                "journaled_modules", "durability_modules"):
        for rel in getattr(cfg, key):
            assert os.path.exists(os.path.join(REPO_ROOT, rel)), rel


def test_port_tree_lints_clean_with_reasoned_waivers():
    report = lint_tree(REPO_ROOT, load_config(REPO_ROOT))
    assert report.violations == [], [str(f) for f in report.violations]
    assert report.warnings == []
    assert report.stale == [], [str(f) for f in report.stale]
    assert all(f.waiver_reason for f in report.waivers)
    assert {f.rule for f in report.waivers} >= {"GL101", "GL103", "GL203"}


def test_port_journal_kinds_are_exhaustive():
    from shrewd_tpu_torch.analysis.ast_lint import _FileLint

    cfg = load_config(REPO_ROOT)
    fls = [_FileLint(os.path.join(REPO_ROOT, rel), rel, cfg)
           for rel in sorted(set(cfg.journaled_modules)
                             | set(cfg.durability_modules))]
    appended, handled, dispatch = replay_lint.collect_journal_kinds(fls,
                                                                    cfg)
    assert dispatch is not None
    assert set(appended) == handled
    rcfg = RefConfig()
    from shrewd_tpu.analysis import load_config as ref_load

    rcfg = ref_load(REPO_ROOT)
    rfls = [ref_lint._FileLint(os.path.join(REPO_ROOT, rel), rel, rcfg)
            for rel in sorted(set(rcfg.journaled_modules)
                              | set(rcfg.durability_modules))]
    assert set(appended) == set(ref_replay.collect_journal_kinds(
        rfls, rcfg)[0])


# --- the CLI ------------------------------------------------------------------

def _fixture_repo(tmp_path, waived: bool) -> str:
    """A tiny tree with one GL101 finding and one stale waiver."""
    waiver = "# graftlint: allow-jit -- fixture: waived for the gate\n" \
        if waived else ""
    _write(str(tmp_path), "shrewd_tpu_torch", "parallel/campaign.py",
           "from x import TrialKernel\n" + waiver
           + "k = TrialKernel(None)\n"
           "# graftlint: allow-wall-clock -- fixture: stale on purpose\n"
           "plain = 1\n")
    return str(tmp_path)


def test_cli_sarif_export_and_audit_waivers_gate(tmp_path, capsys):
    root = _fixture_repo(tmp_path, waived=False)
    sarif_path, json_path = str(tmp_path / "o.sarif"), str(tmp_path / "o.json")
    argv = ["--no-jaxpr", "--root", root, "--sarif", sarif_path,
            "--json", json_path]
    assert graftlint_cli.main(argv) == 1          # the GL101 violation
    sarif = json.load(open(sarif_path))
    assert sarif["version"] == "2.1.0"
    results = sarif["runs"][0]["results"]
    assert any(r["ruleId"] == "GL101" and r["level"] == "error"
               for r in results)
    loc = results[0]["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"].endswith("campaign.py")
    rules = {x["id"] for x in sarif["runs"][0]["tool"]["driver"]["rules"]}
    assert {"GL101", "GL201", "GL205"} <= rules
    doc = json.load(open(json_path))
    assert len(doc["stale_waivers"]) == 1 and not doc["ok"]
    # the violation waived, the stale waiver alone decides the rc
    _fixture_repo(tmp_path, waived=True)
    assert graftlint_cli.main(argv) == 0
    assert graftlint_cli.main(argv + ["--audit-waivers"]) == 1
    assert "STALE" in capsys.readouterr().out
    assert graftlint_cli.main(["--platform", "tpu", "--no-jaxpr"]) == 2


def test_cli_on_the_port_tree_writes_nothing_unless_asked(tmp_path,
                                                          capsys):
    before = set(os.listdir(REPO_ROOT))
    assert graftlint_cli.main(["--no-jaxpr", "--strict",
                               "--audit-waivers"]) == 0
    assert set(os.listdir(REPO_ROOT)) == before
    out = capsys.readouterr().out
    assert "0 violation(s)" in out and "0 stale" in out
