"""GL2xx: static crash/replay-safety certification of the fleet layer
(the port's copy of ``shrewd_tpu/analysis/replay_lint.py``: the same
passes, scoped by ``graftlint.toml`` to the port's journaled modules).

The GL1xx passes (``ast_lint.py``) prove *determinism* preconditions;
these passes prove the *crash-safety* preconditions the write-ahead
journal contract rests on.  Until now "journal BEFORE any state change",
"fsync before rename" and "every journaled kind has a replay handler"
were hand-maintained discipline; here they become statically
certifiable, the way the coherence models are validated by exhaustive
checking against the SLICC sources rather than by review.

========  ====================  =======================================
GL201     journal-before-       in journaled modules, any mutation of
          mutate                journaled scheduler state (tenant
                                status/vtime/quota/failure-ledger
                                attributes) must be **dominated** by a
                                journal call (``_jlog``/WAL append) in
                                the same function — computed over a
                                per-function CFG, so a mutation on any
                                path the journal call does not cover is
                                a finding.  Constructors and the replay
                                path (which must NOT re-journal) are
                                exempt via ``replay_functions``.
GL202     journal-exhaustive    the set of record kinds appended
                                anywhere must exactly equal the set the
                                replay dispatch (``_apply_record``)
                                handles — a new journal record without
                                a replay handler is a lint error, not a
                                silent recovery gap (cross-module
                                symbol-set check)
GL203     fsync-rename          extends GL103 into ordering: every
                                ``os.replace``/``os.rename`` in a
                                durability module must be dominated by
                                an ``os.fsync``/``fsync_dir`` call (a
                                rename of unsynced bytes can persist
                                garbage), and no artifact a recovery
                                path reads may be written with a raw
                                ``open(..., 'w')``
GL204     best-effort-guard     best-effort observability seams
                                (metrics ``publish``, ``flight_dump``)
                                must be exception-guarded at the call
                                site — observability must never turn
                                one failure into two
========  ====================  =======================================

Dominance here is the classic CFG notion: statement J dominates
statement M iff every path from function entry to M passes through J —
exactly the guarantee the WAL contract needs ("by the time this
mutation runs, the journal record is durable on EVERY path").

Pure ``ast`` work, like ``ast_lint``: it imports nothing of torch.
"""

from __future__ import annotations

import ast

#: attribute names that count as renames (GL203) and syncs
_RENAMES = {"replace", "rename"}
_FSYNCS = {"fsync", "fsync_dir"}

#: method calls that mutate a list/dict attribute in place (GL201)
_MUTATOR_METHODS = {"append", "extend", "insert", "clear", "pop",
                    "remove", "update", "setdefault"}

#: handler types that count as a broad guard (GL204)
_BROAD_EXC = {"Exception", "BaseException"}

#: loop statements (one body re-entry edge each)
_LOOPS = (ast.For, ast.AsyncFor, ast.While)


# --------------------------------------------------------------------------
# statement-level CFG + dominators
# --------------------------------------------------------------------------

class _Entry:
    """Synthetic entry node (a function's body may start with any
    statement; dominance needs one root)."""

    lineno = 0


class StmtCFG:
    """Control-flow graph over one function's statements.

    Nodes are the function's statement AST objects (plus a synthetic
    entry and the ``excepthandler`` nodes); edges approximate Python
    control flow: if/else joins, loop back-edges plus the zero-trip
    exit, try-body statements may reach any handler (conservatively
    modeled as the handler being reachable from the *try entry*, so
    nothing inside the try body dominates handler code), and
    return/raise/break/continue terminate or redirect.  Nested function
    definitions are opaque single nodes — their bodies get their own
    CFG when analyzed.
    """

    def __init__(self, func: ast.AST):
        self.entry = _Entry()
        self.preds: dict = {self.entry: set()}
        self.stmts: list = []
        self._loop_stack: list = []     # (header, break-set)
        exits = self._seq(func.body, {self.entry})
        del exits  # falling off the end returns; no exit node needed

    # --- construction ---------------------------------------------------

    def _link(self, node, preds) -> None:
        self.preds.setdefault(node, set()).update(preds)
        if node not in self.stmts:
            self.stmts.append(node)

    def _seq(self, stmts, preds):
        for st in stmts:
            preds = self._stmt(st, preds)
            if not preds:
                break                       # code after this is unreachable
        return preds

    def _stmt(self, st, preds):
        self._link(st, preds)
        if isinstance(st, ast.If):
            then_exits = self._seq(st.body, {st})
            else_exits = self._seq(st.orelse, {st}) if st.orelse else {st}
            return then_exits | else_exits
        if isinstance(st, _LOOPS):
            self._loop_stack.append((st, set()))
            body_exits = self._seq(st.body, {st})
            for e in body_exits:            # back edge
                self.preds[st].add(e)
            _, breaks = self._loop_stack.pop()
            # zero-trip / loop-done exit is the header itself
            exits = {st} | breaks
            if st.orelse:
                exits = self._seq(st.orelse, {st}) | breaks
            return exits
        if isinstance(st, ast.Try):
            body_exits = self._seq(st.body, {st})
            handler_exits = set()
            for h in st.handlers:
                # an exception can fire before ANY body statement ran:
                # the handler's only dominating predecessor is the try
                # entry, never the body
                self._link(h, {st})
                handler_exits |= self._seq(h.body, {h})
            out = body_exits | handler_exits
            if st.orelse:
                out = self._seq(st.orelse, body_exits or {st}) \
                    | handler_exits
            if st.finalbody:
                out = self._seq(st.finalbody, out or {st})
            return out
        if isinstance(st, (ast.With, ast.AsyncWith)):
            return self._seq(st.body, {st})
        if isinstance(st, (ast.Return, ast.Raise)):
            return set()
        if isinstance(st, ast.Break):
            if self._loop_stack:
                self._loop_stack[-1][1].add(st)
            return set()
        if isinstance(st, ast.Continue):
            if self._loop_stack:
                self.preds[self._loop_stack[-1][0]].add(st)
            return set()
        return {st}

    # --- dominators ------------------------------------------------------

    def dominators(self) -> dict:
        """node -> set of nodes that dominate it (including itself).
        Classic iterative data-flow; function bodies are small enough
        that convergence order does not matter."""
        nodes = [self.entry] + self.stmts
        universe = set(nodes)
        dom = {n: set(universe) for n in nodes}
        dom[self.entry] = {self.entry}
        changed = True
        while changed:
            changed = False
            for n in self.stmts:
                preds = self.preds.get(n, set())
                if preds:
                    new = set.intersection(*(dom[p] for p in preds))
                else:                       # unreachable: only itself
                    new = set()
                new.add(n)
                if new != dom[n]:
                    dom[n] = new
                    changed = True
        return dom


# --------------------------------------------------------------------------
# shared AST helpers
# --------------------------------------------------------------------------

def _dotted(node) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _call_name(call: ast.Call) -> str:
    """Trailing name of the called function ('' when unnameable)."""
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


def _is_journal_call(call: ast.Call, jnames: set) -> bool:
    """A WAL append: a configured journal-call name (``_jlog``), or
    ``.append(...)`` on a receiver whose dotted name ends in
    ``journal`` (``self._journal.append``, ``j.append`` does not count
    — naming the receiver is part of the contract)."""
    name = _call_name(call)
    if name in jnames:
        return True
    if name == "append" and isinstance(call.func, ast.Attribute):
        recv = _dotted(call.func.value)
        return recv.endswith("journal") or recv.endswith("_journal")
    return False


def _walk_own(stmt):
    """ast.walk, but stopping at nested function/class definitions —
    their bodies belong to their own analysis."""
    stack = [stmt]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            stack.append(child)


def _is_kind_expr(e, kindvars: set) -> bool:
    """An expression carrying the record's ``kind`` field: a name bound
    from it, ``r.get("kind")``, or ``r["kind"]``."""
    if isinstance(e, ast.Name) and e.id in kindvars:
        return True
    if isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute) \
            and e.func.attr == "get" and e.args \
            and isinstance(e.args[0], ast.Constant) \
            and e.args[0].value == "kind":
        return True
    if isinstance(e, ast.Subscript) \
            and isinstance(e.slice, ast.Constant) \
            and e.slice.value == "kind":
        return True
    return False


def _kind_vars(func) -> set:
    """Names assigned from the record's ``kind`` field inside the
    replay dispatch."""
    out = set()
    for node in _walk_own(func):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and _is_kind_expr(node.value, set()):
            out.add(node.targets[0].id)
    return out


def _handled_kinds(func) -> set:
    """String literals the dispatch compares the kind against —
    restricted to comparisons that actually involve the kind variable,
    so ``"rc" in r`` field probes don't read as handled kinds."""
    kindvars = _kind_vars(func)
    handled: set = set()
    for node in _walk_own(func):
        if not isinstance(node, ast.Compare):
            continue
        sides = [node.left, *node.comparators]
        if not any(_is_kind_expr(s, kindvars) for s in sides):
            continue
        for s in sides:
            if _is_kind_expr(s, kindvars):
                continue
            for c in ast.walk(s):
                if isinstance(c, ast.Constant) \
                        and isinstance(c.value, str):
                    handled.add(c.value)
    return handled


def _store_attr_nodes(t):
    """The Attribute nodes a store to target ``t`` actually MUTATES —
    subscript *keys* are reads (``out[t.status] = n`` mutates ``out``,
    not ``status``), while a subscripted base is mutated
    (``t.errors[0] = x`` mutates ``errors``)."""
    if isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            yield from _store_attr_nodes(e)
    elif isinstance(t, ast.Starred):
        yield from _store_attr_nodes(t.value)
    elif isinstance(t, ast.Attribute):
        yield t
    elif isinstance(t, ast.Subscript):
        yield from _store_attr_nodes(t.value)


def _mutations_in(scope, tracked: set):
    """``(node, attr)`` for every mutation of a tracked attribute inside
    ``scope`` (nested defs excluded): attribute (aug)assignment,
    in-place mutator method call (``t.errors.append``), and ``del`` of
    a tracked attribute (or one of its items)."""
    for node in _walk_own(scope):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for a in _store_attr_nodes(t):
                    if a.attr in tracked:
                        yield node, a.attr
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                for a in _store_attr_nodes(t):
                    if a.attr in tracked:
                        yield node, a.attr
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATOR_METHODS \
                and isinstance(node.func.value, ast.Attribute) \
                and node.func.value.attr in tracked:
            yield node, node.func.value.attr


def _functions(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


# --------------------------------------------------------------------------
# GL201: journal-before-mutate
# --------------------------------------------------------------------------

def _owner_stmt(node, par, cfg_nodes):
    """The innermost CFG statement containing ``node`` (None for code
    the CFG never linked — unreachable statements)."""
    n = node
    while n is not None and n not in cfg_nodes:
        n = par.get(n)
    return n


def check_journal_before_mutate(fl) -> None:
    """Every mutation of journaled scheduler state must be dominated by
    a journal call in the same function (see module doc)."""
    cfg = fl.cfg
    tracked = set(cfg.journaled_attrs)
    jnames = set(cfg.journal_call_names)
    exempt = set(cfg.replay_functions)
    for func in _functions(fl.tree):
        if func.name in exempt:
            continue
        # cheap pre-scan: no tracked mutation, no CFG needed
        muts = list(_mutations_in(func, tracked))
        if not muts:
            continue
        g = StmtCFG(func)
        cfg_nodes = set(g.stmts)
        dom = g.dominators()
        # only the INNERMOST statement owning a journal call counts —
        # an If that journals in one branch must not certify paths
        # through the other
        j_stmts = {_owner_stmt(n, fl.par, cfg_nodes)
                   for n in _walk_own(func)
                   if isinstance(n, ast.Call)
                   and _is_journal_call(n, jnames)} - {None}
        for node, attr in muts:
            stmt = _owner_stmt(node, fl.par, cfg_nodes)
            if stmt is not None \
                    and j_stmts & (dom.get(stmt, set()) - {stmt}):
                continue
            fl._report(
                "GL201", node,
                f"journaled scheduler state '.{attr}' mutated in "
                f"{func.name}() without a dominating journal call — the "
                "WAL contract is journal BEFORE the in-memory ledgers "
                "are trusted (_jlog first, mutate after; replay paths "
                "belong in replay_functions)")


# --------------------------------------------------------------------------
# GL203: fsync-before-rename + recovery-read raw writes
# --------------------------------------------------------------------------

def check_fsync_before_rename(fl) -> None:
    """Every os.replace/os.rename must be dominated by an fsync (file or
    dir) in the same function: renaming unsynced bytes can make garbage
    durable and drop the data it replaced."""
    for func in _functions(fl.tree):
        renames = [n for n in _walk_own(func)
                   if isinstance(n, ast.Call)
                   and isinstance(n.func, ast.Attribute)
                   and n.func.attr in _RENAMES
                   and _dotted(n.func.value) == "os"]
        if not renames:
            continue
        g = StmtCFG(func)
        cfg_nodes = set(g.stmts)
        dom = g.dominators()
        sync_stmts = {_owner_stmt(n, fl.par, cfg_nodes)
                      for n in _walk_own(func)
                      if isinstance(n, ast.Call)
                      and _call_name(n) in _FSYNCS} - {None}
        for node in renames:
            stmt = _owner_stmt(node, fl.par, cfg_nodes)
            if stmt is not None \
                    and sync_stmts & (dom.get(stmt, set()) - {stmt}):
                continue
            fl._report(
                "GL203", node,
                f"os.{node.func.attr}() in {func.name}() with no "
                "dominating fsync — durability ordering is file-fsync "
                "THEN rename THEN dir-fsync; renaming unsynced bytes "
                "can persist garbage (or waive with a reason if the "
                "source is already durable)")


def collect_recovery_reads(file_lints, cfg) -> set:
    """Basenames of artifacts any recovery function reads — the
    crash-surface read set GL203 protects from raw writes."""
    reads: set = set()
    wanted = set(cfg.recovery_functions)
    for fl in file_lints:
        consts = _module_str_constants(fl.tree)
        for func in _functions(fl.tree):
            if func.name not in wanted:
                continue
            for node in ast.walk(func):
                if isinstance(node, ast.Constant) \
                        and isinstance(node.value, str) \
                        and node.value.endswith((".json", ".jsonl")):
                    reads.add(node.value)
                elif isinstance(node, ast.Name) and node.id in consts:
                    reads.add(consts[node.id])
    return reads


def _module_str_constants(tree) -> dict:
    """Module-level ``NAME = "literal.json"`` bindings (the artifact
    name constants recovery paths share with writers)."""
    out = {}
    for st in tree.body:
        if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                and isinstance(st.targets[0], ast.Name) \
                and isinstance(st.value, ast.Constant) \
                and isinstance(st.value.value, str) \
                and st.value.value.endswith((".json", ".jsonl")):
            out[st.targets[0].id] = st.value.value
    return out


def check_recovery_read_raw_writes(fl, recovery_reads: set) -> None:
    """A raw ``open(..., 'w')`` of an artifact the recovery path reads
    can tear the crash surface itself — those writes go through the
    atomic writer (tmp + fsync + rename + dir-fsync)."""
    consts = _module_str_constants(fl.tree)
    for func in _functions(fl.tree):
        if func.name == "write_json_atomic":
            continue                         # the sanctioned implementation
        for node in ast.walk(func):
            # builtin open only: os.open file-descriptor paths are the
            # lock/placeholder idiom, not document writes
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "open" and node.args):
                continue
            mode = None
            if len(node.args) > 1 and isinstance(node.args[1],
                                                 ast.Constant):
                mode = node.args[1].value
            for kw in node.keywords:
                if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                    mode = kw.value.value
            if not (isinstance(mode, str) and "w" in mode):
                continue
            names = {n.value for n in ast.walk(node.args[0])
                     if isinstance(n, ast.Constant)
                     and isinstance(n.value, str)}
            names |= {consts[n.id] for n in ast.walk(node.args[0])
                      if isinstance(n, ast.Name) and n.id in consts}
            if ".tmp" in names:
                continue                     # the atomic-writer tmp leg
            hit = names & recovery_reads
            if hit:
                fl._report(
                    "GL203", node,
                    f"raw open(..., {mode!r}) of {sorted(hit)[0]!r} — an "
                    "artifact the recovery path reads; a torn write here "
                    "tears the crash surface itself.  Route it through "
                    "resilience.write_json_atomic")


# --------------------------------------------------------------------------
# GL202: journal-record-kind exhaustiveness (cross-module)
# --------------------------------------------------------------------------

def collect_journal_kinds(file_lints, cfg):
    """``(appended, handled, dispatch_site)`` across a module set:
    ``appended`` maps each literal record kind to its first append site
    ``(fl, node)``; ``handled`` is the set of kinds the replay dispatch
    compares against; ``dispatch_site`` is ``(fl, funcdef)`` or None."""
    jnames = set(cfg.journal_call_names)
    appended: dict = {}
    handled: set = set()
    dispatch_site = None
    for fl in file_lints:
        for node in ast.walk(fl.tree):
            if isinstance(node, ast.Call) \
                    and _is_journal_call(node, jnames) and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                appended.setdefault(node.args[0].value, (fl, node))
        for func in _functions(fl.tree):
            if func.name != cfg.replay_dispatch:
                continue
            dispatch_site = (fl, func)
            handled |= _handled_kinds(func)
    return appended, handled, dispatch_site


def check_journal_exhaustive(file_lints, cfg) -> None:
    """Appended kinds must all be handled by the replay dispatch (error
    at the append site); kinds the dispatch handles but nothing appends
    are rot (warning at the dispatch)."""
    appended, handled, dispatch_site = collect_journal_kinds(
        file_lints, cfg)
    if not appended:
        return
    if dispatch_site is None:
        fl, node = next(iter(appended.values()))
        fl._report(
            "GL202", node,
            f"journal records are appended but no replay dispatch "
            f"({cfg.replay_dispatch}) exists in the scoped modules — "
            "every record kind needs a replay story")
        return
    for kind in sorted(set(appended) - handled):
        fl, node = appended[kind]
        fl._report(
            "GL202", node,
            f"journal record kind {kind!r} is appended but "
            f"{cfg.replay_dispatch}() never handles it — a hard kill "
            "after this append replays into a silent recovery gap "
            "(add a dispatch arm, even an explicit informational "
            "no-op)")
    dfl, dfunc = dispatch_site
    for kind in sorted(handled - set(appended)):
        dfl._report(
            "GL202", dfunc,
            f"replay dispatch handles kind {kind!r} but nothing appends "
            "it — dead replay arm (or the appender moved out of the "
            "scoped modules)", severity="warn")


# --------------------------------------------------------------------------
# GL204: best-effort seams must be exception-guarded
# --------------------------------------------------------------------------

def _handler_is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = [t] if not isinstance(t, ast.Tuple) else list(t.elts)
    for n in names:
        if isinstance(n, ast.Name) and n.id in _BROAD_EXC:
            return True
        if isinstance(n, ast.Attribute) and n.attr in _BROAD_EXC:
            return True
    return False


def _guarded(node, par) -> bool:
    """True when ``node`` sits in the try-body of a Try whose handlers
    include a broad (Exception/bare) catch."""
    child = node
    while child in par:
        anc = par[child]
        if isinstance(anc, ast.Try) and child in anc.body \
                and any(_handler_is_broad(h) for h in anc.handlers):
            return True
        child = anc
    return False


def check_best_effort_guard(fl) -> None:
    names = set(fl.cfg.best_effort_calls)
    for node in ast.walk(fl.tree):
        if not isinstance(node, ast.Call):
            continue
        if _call_name(node) not in names:
            continue
        if _guarded(node, fl.par):
            continue
        fl._report(
            "GL204", node,
            f"best-effort seam {_call_name(node)}() called unguarded — "
            "observability must never turn one failure into two; wrap "
            "the call in try/except Exception (or waive with a reason "
            "if the callee is provably total)")
