"""Layer-2 static analysis: repo-specific AST lint passes over the port
(the port of ``shrewd_tpu/analysis/ast_lint.py``; GL102, GL103 and GL106
are its passes unchanged, GL101, GL104 and GL105 are re-scoped to what the
port shares and how it derives keys).

The dynamic layers (pinned tests, in-run canaries, the integrity
quarantine) prove determinism *after* code runs; these passes prove the
repo-specific preconditions *before* anything runs, the way the reference
builds its CheckerCPU redundancy into the design rather than the test
suite.  Six rules, each encoding a contract another subsystem already
depends on:

========  ============  =====================================================
GL101     jit           in campaign-critical modules every ``TrialKernel``
                        must be built inside the build callable of the
                        process-wide kernel registry
                        (``parallel/exec_cache.py shared_kernel`` —
                        content-keyed, so tenants, a re-built orchestrator
                        and the fallback tier share one kernel and its
                        golden record), and no step is handed to
                        ``torch.compile`` / ``torch.jit``: the port shares
                        kernels, not compiled executables
GL102     wall-clock    no wall-clock *reads* (``time.time``,
                        ``datetime.now``, ...) inside deterministic
                        chaos/elastic regions — triggers are pure functions
                        of campaign coordinates (the chaos DSL's
                        no-wall-clock rule); ``time.sleep`` and
                        ``time.monotonic`` perf ledgers are not reads of
                        schedule-bearing state and are not flagged
GL103     raw-write     persisted JSON documents in checkpoint-bearing
                        modules must go through
                        ``resilience.write_json_atomic`` (tmp + fsync +
                        rename + dir-fsync); a bare ``json.dump`` can tear
GL104     key-reuse     a PRNG key consumed by ``prng.split`` must not be
                        passed to another ``prng`` call afterwards (key
                        reuse makes two "independent" samples collide;
                        ``fold_in`` with distinct coordinates is the
                        sanctioned derivation idiom)
GL105     key-genesis   ``prng.threefry_seed``, ``torch.Generator(…)`` and
                        ``torch.manual_seed`` only in ``utils/prng.py`` —
                        every key derives from the plan seed through the
                        campaign-coordinate helpers, which is what makes
                        re-dispatch on frozen keys possible
GL106     clock         obs-instrumented modules read clocks only through
                        the sanctioned ``obs.clock`` seam (``time.time`` /
                        ``monotonic`` / ``perf_counter`` and ``_ns``
                        variants) — timestamps attach to events without
                        wall clock scattering into deterministic regions;
                        ``time.sleep`` is not a read and is not flagged
========  ============  =====================================================

The GL2xx *crash/replay-safety* family (journal-before-mutate dominance,
journal-kind exhaustiveness, fsync-before-rename ordering, best-effort
guards) lives in ``replay_lint.py`` and runs through the same scoping,
waiver and severity machinery; ``lint_tree`` additionally audits for
**stale waivers** (GL205) — waiver comments no rule matched.

**Waivers**: a finding is waived by a comment on the same line, the line
above, or a decorator line of the flagged statement::

    # graftlint: allow-<rule-name> -- <reason>

The reason is mandatory — a reasonless waiver is itself reported (the
waiver ledger is evidence, not an off switch).

Pure ``ast`` work: it imports nothing of torch, so the linter runs where
no accelerator stack is installed.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field

from shrewd_tpu_torch.analysis import replay_lint
from shrewd_tpu_torch.analysis.config import RULES, GraftlintConfig

#: call-router names that mark a kernel construction as registry-routed
#: (GL101): an enclosing def named build*/_build*, or an enclosing call to
#: the registry's surface
_ROUTERS = {"shared_kernel"}

#: the kernel class whose construction GL101 routes
_KERNEL_CLASSES = {"TrialKernel"}

#: compiled-step surfaces GL101 flags wherever they appear
_COMPILERS = {"torch.compile", "torch.jit.script", "torch.jit.trace"}

#: key genesis outside utils/prng.py (GL105)
_KEY_GENESIS = {"prng.threefry_seed", "threefry_seed", "torch.Generator",
                "torch.manual_seed", "torch.random.manual_seed",
                "torch.cuda.manual_seed", "torch.cuda.manual_seed_all"}

#: wall-clock reads (GL102) — (module-ish qualifier, attr)
_WALL_CLOCK = {
    ("time", "time"), ("time", "time_ns"),
    ("datetime", "now"), ("datetime", "utcnow"), ("datetime", "today"),
    ("date", "today"),
}

#: clock reads of ANY kind (GL106): in obs-instrumented modules these
#: must route through the sanctioned ``obs.clock`` seam —
#: ``time.sleep`` is not a read and stays unflagged
_CLOCK_READS = {
    ("time", "time"), ("time", "time_ns"),
    ("time", "monotonic"), ("time", "monotonic_ns"),
    ("time", "perf_counter"), ("time", "perf_counter_ns"),
}

_WAIVER_RE = re.compile(
    r"#\s*graftlint:\s*allow-([a-z-]+)(?:\s*--\s*(\S.*))?")


@dataclass
class Finding:
    rule: str                  # GLxxx
    path: str                  # repo-relative file path
    line: int
    msg: str
    waived: bool = False
    waiver_reason: str = ""
    severity: str = "error"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "name": RULES.get(self.rule, self.rule),
                "path": self.path, "line": self.line, "msg": self.msg,
                "waived": self.waived, "waiver_reason": self.waiver_reason,
                "severity": self.severity}

    def __str__(self) -> str:
        tag = " (waived: %s)" % self.waiver_reason if self.waived else ""
        return f"{self.path}:{self.line}: {self.rule} {self.msg}{tag}"


@dataclass
class LintReport:
    findings: list = field(default_factory=list)
    #: GL205: waiver comments whose rule no longer fires at their site
    #: (the reasoned-waiver ledger must not rot) — kept apart from
    #: ``findings`` so ``violations`` semantics (and --baseline keys)
    #: stay stable; the CLI gates on these under ``--audit-waivers``
    stale: list = field(default_factory=list)

    @property
    def violations(self) -> list:
        return [f for f in self.findings
                if not f.waived and f.severity == "error"]

    @property
    def warnings(self) -> list:
        return [f for f in self.findings
                if not f.waived and f.severity == "warn"]

    @property
    def waivers(self) -> list:
        return [f for f in self.findings if f.waived]

    def to_dict(self) -> dict:
        return {"violations": [f.to_dict() for f in self.violations],
                "warnings": [f.to_dict() for f in self.warnings],
                "waivers": [f.to_dict() for f in self.waivers],
                "stale_waivers": [f.to_dict() for f in self.stale]}


def _parents(tree: ast.AST) -> dict:
    par = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            par[child] = node
    return par


def _ancestors(node, par):
    while node in par:
        node = par[node]
        yield node


def _dotted(node) -> str:
    """``a.b.c`` for an Attribute/Name chain, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_kernel_build(node) -> bool:
    """A ``TrialKernel(...)`` call (bare or module-qualified)."""
    fn = node.func
    name = fn.attr if isinstance(fn, ast.Attribute) else \
        (fn.id if isinstance(fn, ast.Name) else "")
    return name in _KERNEL_CLASSES


class _FileLint:
    """All passes over one file (parse once, share parents/waivers)."""

    def __init__(self, path: str, rel: str, cfg: GraftlintConfig):
        self.rel = rel.replace(os.sep, "/")
        self.cfg = cfg
        with open(path) as f:
            self.src = f.read()
        self.tree = ast.parse(self.src, filename=path)
        self.par = _parents(self.tree)
        self.lines = self.src.splitlines()
        # line -> (rule-name, reason|None); a reason may continue over
        # following pure-comment lines (joined — the waiver ledger is
        # evidence and should read whole)
        self.waiver_lines: dict[int, tuple[str, str | None]] = {}
        for i, line in enumerate(self.lines, 1):
            m = _WAIVER_RE.search(line)
            if not m:
                continue
            reason = m.group(2)
            j = i
            while reason is not None and j < len(self.lines):
                nxt = self.lines[j].strip()
                if not nxt.startswith("#") or _WAIVER_RE.search(nxt):
                    break
                reason = f"{reason} {nxt.lstrip('#').strip()}"
                j += 1
            self.waiver_lines[i] = (m.group(1), reason)
        #: waiver lines some rule actually matched (the complement is
        #: the stale-waiver set — ledger rot the --audit-waivers gate
        #: fails on)
        self.consumed: set[int] = set()
        self.findings: list[Finding] = []

    # --- waiver lookup --------------------------------------------------

    def _scan_up(self, start: int, rule_name: str, depth: int = 8):
        """A waiver on ``start``'s own line or in the contiguous comment/
        blank block immediately above it (multi-line waiver prose keeps
        its marker attached to the code it covers)."""
        i = start
        while i >= 1 and start - i <= depth:
            got = self.waiver_lines.get(i)
            if got and got[0] == rule_name:
                return (i, *got)
            i -= 1
            text = self.lines[i - 1].strip() if 0 < i <= len(self.lines) \
                else ""
            if i != start and text and not text.startswith("#"):
                break                       # hit real code: stop climbing
        return None

    def _waiver_for(self, node, rule_name: str):
        """The waiver covering ``node`` for ``rule_name``: its own line,
        the comment block above it / its statement, or a decorator."""
        starts = {node.lineno}
        stmt = node
        while stmt in self.par and not isinstance(stmt, (ast.stmt,)):
            stmt = self.par[stmt]
        if isinstance(stmt, ast.stmt):
            starts.add(stmt.lineno)
            for dec in getattr(stmt, "decorator_list", []):
                starts.add(dec.lineno)
        for ln in sorted(starts):
            got = self._scan_up(ln, rule_name)
            if got is not None:
                return got
        return None

    def _report(self, rule: str, node, msg: str,
                severity: str | None = None) -> None:
        name = RULES[rule]
        waiver = self._waiver_for(node, name)
        if waiver is not None:
            # matched = not stale, even when malformed (missing reason)
            # or when the rule is configured off — an off rule's waivers
            # must not rot into GL205 findings, or disabling a rule
            # would force deleting the very waivers re-enabling it needs
            self.consumed.add(waiver[0])
        cfg_sev = self.cfg.rule_severity(rule)
        if cfg_sev == "off":
            return                   # "off" beats any per-call severity
        sev = severity if severity is not None else cfg_sev
        if waiver is not None and not waiver[2]:
            self.findings.append(Finding(
                rule, self.rel, node.lineno,
                f"waiver 'allow-{name}' is missing its reason "
                "(syntax: # graftlint: allow-%s -- <why>)" % name,
                severity=sev))
            return
        self.findings.append(Finding(
            rule, self.rel, node.lineno, msg,
            waived=waiver is not None,
            waiver_reason=waiver[2] if waiver else "",
            severity=sev))

    # --- GL101: kernels outside the registry, compiled steps -------------

    def _routed(self, node) -> bool:
        for anc in _ancestors(node, self.par):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and anc.name.lstrip("_").startswith("build"):
                return True
            if isinstance(anc, ast.Call):
                fn = anc.func
                name = fn.attr if isinstance(fn, ast.Attribute) else \
                    (fn.id if isinstance(fn, ast.Name) else "")
                if name in _ROUTERS:
                    return True
        return False

    def check_bare_jit(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call) and _is_kernel_build(node):
                if self._routed(node):
                    continue
                self._report(
                    "GL101", node,
                    "TrialKernel built outside the kernel registry in a "
                    "campaign-critical module — build it through "
                    "parallel/exec_cache.shared_kernel (content-keyed, "
                    "shared across campaigns) or waive with a reason")
            elif (isinstance(node, ast.Call)
                  and _dotted(node.func) in _COMPILERS) or (
                    isinstance(node, ast.Attribute)
                    and _dotted(node) in _COMPILERS
                    and isinstance(self.par.get(node), (
                        ast.FunctionDef, ast.AsyncFunctionDef))):
                self._report(
                    "GL101", node,
                    f"{_dotted(getattr(node, 'func', node))} in a "
                    "campaign-critical module — the port's steps are "
                    "plain torch around hand-written kernels, certified "
                    "as they run; a compiled step bypasses the step "
                    "auditor")

    # --- GL102: wall clock in deterministic regions ---------------------

    def check_wall_clock(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not isinstance(fn, ast.Attribute):
                continue
            qual = _dotted(fn.value).rsplit(".", 1)[-1]
            if (qual, fn.attr) in _WALL_CLOCK:
                self._report(
                    "GL102", node,
                    f"wall-clock read {qual}.{fn.attr}() in a "
                    "deterministic chaos/elastic module — triggers must "
                    "be pure functions of campaign coordinates (batch "
                    "ids, checkpoint ordinals, seeded samples)")

    # --- GL106: direct clock reads in obs-instrumented modules ----------

    def check_clock(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not isinstance(fn, ast.Attribute):
                continue
            qual = _dotted(fn.value).rsplit(".", 1)[-1]
            if (qual, fn.attr) in _CLOCK_READS:
                self._report(
                    "GL106", node,
                    f"direct clock read {qual}.{fn.attr}() in an "
                    "obs-instrumented module — route it through the "
                    "sanctioned obs.clock seam (clock.monotonic()/"
                    "clock.now()) so timestamps stay auditable at one "
                    "import site, or waive with a reason")

    # --- GL103: raw persisted writes ------------------------------------

    def check_raw_write(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            if _dotted(node.func) not in ("json.dump",):
                continue
            fn_name = ""
            for anc in _ancestors(node, self.par):
                if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fn_name = anc.name
                    break
            if fn_name == "write_json_atomic":
                continue                     # the sanctioned implementation
            self._report(
                "GL103", node,
                "raw json.dump in a checkpoint-bearing module — persisted "
                "documents go through resilience.write_json_atomic "
                "(tmp + fsync + rename + dir-fsync) or carry a waiver "
                "explaining why tearing is acceptable")

    # --- GL104: key reuse after split -----------------------------------
    #
    # ``fold_in`` is NOT a consumer: deriving several children from one
    # parent with distinct coordinates (simpoint_key/batch_key/...) is
    # the framework's addressing scheme.  ``split`` is: its whole
    # contract is that the parent key is dead afterwards.

    _CONSUMERS = {"split"}

    def check_key_reuse(self) -> None:
        for func in ast.walk(self.tree):
            if not isinstance(func, (ast.FunctionDef,
                                     ast.AsyncFunctionDef, ast.Lambda)):
                continue
            consumed: dict[str, int] = {}    # name -> lineno consumed
            rebound: set[str] = set()
            for node in ast.walk(func):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                if not isinstance(fn, ast.Attribute):
                    continue
                if not _dotted(fn).startswith("prng."):
                    continue
                # reuse check first: an already-consumed name as any arg
                for arg in node.args:
                    if isinstance(arg, ast.Name) \
                            and arg.id in consumed \
                            and arg.id not in rebound \
                            and node.lineno > consumed[arg.id]:
                        self._report(
                            "GL104", node,
                            f"PRNG key {arg.id!r} used after "
                            f"prng.{self._consumer_of(arg.id)} "
                            f"(line {consumed[arg.id]}) — a consumed key "
                            "must not be reused (derive fresh keys from "
                            "campaign coordinates instead)")
                if fn.attr in self._CONSUMERS and node.args \
                        and isinstance(node.args[0], ast.Name):
                    name = node.args[0].id
                    # rebinding the same name consumes-and-replaces
                    stmt = self.par.get(node)
                    targets = []
                    if isinstance(stmt, ast.Assign):
                        for t in stmt.targets:
                            targets.extend(
                                n.id for n in ast.walk(t)
                                if isinstance(n, ast.Name))
                    if name in targets:
                        rebound.add(name)
                    elif name not in consumed:
                        consumed[name] = node.lineno
                        self._last_consumer = getattr(
                            self, "_last_consumer", {})
                        self._last_consumer[name] = fn.attr

    def _consumer_of(self, name: str) -> str:
        return getattr(self, "_last_consumer", {}).get(name, "split")

    # --- GL105: key genesis outside utils/prng --------------------------

    def check_key_genesis(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            if _dotted(node.func) in _KEY_GENESIS:
                self._report(
                    "GL105", node,
                    "PRNG key genesis outside utils/prng.py — every key "
                    "derives from the plan seed through the campaign-"
                    "coordinate helpers (trial_key/batch_key/...), which "
                    "is what makes frozen-key re-dispatch bit-identical")


def _run_file_passes(fl: _FileLint, cfg: GraftlintConfig,
                     recovery_reads: set | None = None) -> None:
    """Every per-file pass the file's path scopes it into.  The GL2xx
    replay-safety passes live in ``replay_lint.py``; ``recovery_reads``
    is the cross-module artifact read set (computed over the whole
    durability scope by ``lint_tree``; single-file mode derives it from
    the file itself)."""
    rel_n = fl.rel
    if rel_n in cfg.jit_modules:
        fl.check_bare_jit()
    if rel_n in cfg.deterministic_modules:
        fl.check_wall_clock()
    if rel_n in cfg.checkpoint_modules:
        fl.check_raw_write()
    if rel_n in cfg.clock_modules:
        fl.check_clock()
    fl.check_key_reuse()
    if rel_n not in cfg.key_genesis_allow:
        fl.check_key_genesis()
    if rel_n in cfg.journaled_modules:
        replay_lint.check_journal_before_mutate(fl)
    if rel_n in cfg.durability_modules:
        replay_lint.check_fsync_before_rename(fl)
        reads = recovery_reads if recovery_reads is not None \
            else replay_lint.collect_recovery_reads([fl], cfg)
        replay_lint.check_recovery_read_raw_writes(fl, reads)
    if rel_n in cfg.best_effort_modules:
        replay_lint.check_best_effort_guard(fl)


def stale_waivers(fl: _FileLint) -> list:
    """GL205: waiver comments no rule matched after every applicable
    pass ran — a waiver whose finding evaporated (code moved, rule
    rescoped) is ledger rot, not evidence."""
    out = []
    for line, (name, _reason) in sorted(fl.waiver_lines.items()):
        if line in fl.consumed:
            continue
        sev = fl.cfg.rule_severity("GL205")
        if sev == "off":
            continue
        out.append(Finding(
            "GL205", fl.rel, line,
            f"stale waiver 'allow-{name}': the rule does not fire at "
            "this site any more — delete the waiver (the reasoned-"
            "waiver ledger is evidence and must not rot)",
            severity=sev))
    return out


def lint_file(path: str, rel: str, cfg: GraftlintConfig) -> list:
    """Every applicable pass over one file → findings (single-file
    surface for fixtures; the cross-module GL202 pass and the stale-
    waiver audit run only from ``lint_tree``)."""
    fl = _FileLint(path, rel, cfg)
    _run_file_passes(fl, cfg)
    return fl.findings


def lint_tree(root: str, cfg: GraftlintConfig | None = None,
              package: str = "shrewd_tpu_torch") -> LintReport:
    """Lint every ``.py`` file under ``<root>/<package>`` → LintReport:
    per-file passes, then the cross-module GL202 journal-kind
    exhaustiveness check, then the GL205 stale-waiver audit (a waiver
    is stale only once every pass that could consume it has run)."""
    cfg = cfg if cfg is not None else GraftlintConfig()
    report = LintReport()
    base = os.path.join(root, package)
    fls: list[_FileLint] = []
    for dirpath, _dirnames, filenames in os.walk(base):
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            fls.append(_FileLint(path, rel, cfg))
    fls.sort(key=lambda fl: fl.rel)
    dur = [fl for fl in fls if fl.rel in cfg.durability_modules]
    reads = replay_lint.collect_recovery_reads(dur, cfg)
    for fl in fls:
        _run_file_passes(fl, cfg, recovery_reads=reads)
    journal_scope = set(cfg.journaled_modules) | set(cfg.durability_modules)
    replay_lint.check_journal_exhaustive(
        [fl for fl in fls if fl.rel in journal_scope], cfg)
    for fl in fls:
        report.findings.extend(fl.findings)
        report.stale.extend(stale_waivers(fl))
    report.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    report.stale.sort(key=lambda f: (f.path, f.line))
    return report
