"""Paper-style VCS statements: the SQL-flavored front-end.

The paper's user surface is *statements* — ``CREATE SNAPSHOT``, ``CLONE
TABLE ... {SNAPSHOT = ...}``, diff/merge/publish as SQL against named
versions. This module parses that surface and dispatches to the ``Repo``
facade, so a statement-driven session takes EXACTLY the code paths (and
writes the identical WAL) of the equivalent Python calls. This is the
port's own pure-Python copy of the reference's statement layer, with the
same grammar, messages and did-you-mean suggestions.

Supported statements (keywords case-insensitive; refs quoted or bare)::

    CREATE BRANCH dev [FROM main] [FOR (orders, lineitem)]
    DROP BRANCH dev
    CREATE SNAPSHOT nightly FOR TABLE orders
    DROP SNAPSHOT nightly
    CLONE TABLE orders2 FROM 'snap:nightly' [MATERIALIZE]
    DIFF TABLE orders AGAINST 'snap:nightly'
    DIFF 'orders~2' AGAINST 'HEAD' [FOR TABLE orders]
    MERGE BRANCH dev INTO main [MODE ours] [FOR (orders)]
    MERGE 'snap:nightly' INTO TABLE orders [MODE theirs]
    OPEN PR FROM dev [INTO main]
    CHECK PR 3
    PUBLISH PR 3 [MODE accept]
    CLOSE PR 3
    REVERT PR 3
    REVERT TABLE orders FROM 'orders~1' TO 'HEAD'
    RESTORE TABLE orders TO 'snap:nightly'
    LOG TABLE orders [LIMIT 10]
    SHOW BRANCHES | SNAPSHOTS | PRS | TABLES
    STATUS
    STATS
    EXPLAIN <any statement above>
    GC
    FSCK [REPAIR]
    LINT
    PUSH TO '/path/to/remote'
    PULL FROM '/path/to/remote'
    FETCH FROM '/path/to/remote'

``execute(repo, text)`` runs one statement; ``execute_script`` splits on
``;``. Unknown verbs raise :class:`StatementError` with did-you-mean
suggestions, resolution failures surface the typed ref errors unchanged.
``LINT`` runs the port's invariant lint (``repro_torch.analysis``) over
the port's source tree, not over the repo's data.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, List, Optional

from . import telemetry
from .refs import did_you_mean, suggest

SP_EXPLAIN = telemetry.register_span(
    "explain", "EXPLAIN wrapper when a tracer is already armed — the "
    "explained statement's spans nest under it")

_TOKEN_RE = re.compile(r"\s*(?:'(?P<str>[^']*)'|(?P<punct>[(),])"
                       r"|(?P<word>[^\s(),;']+))")

class StatementError(ValueError):
    """The statement text does not parse."""

    def __init__(self, text: str, why: str, suggestions=()):
        super().__init__(f"cannot parse {text!r}: {why}"
                         f"{did_you_mean(suggestions)}")
        self.statement = text
        self.suggestions = tuple(suggestions)


@dataclass
class StatementResult:
    """What one statement did: machine data + a human line for the CLI."""
    kind: str                      # e.g. "create_branch", "diff", "publish"
    data: Any = None
    message: str = ""

    def __str__(self) -> str:      # CLI prints results directly
        return self.message


# --------------------------------------------------------------------------
# tokenizer / parser scaffolding
# --------------------------------------------------------------------------

class _P:
    def __init__(self, text: str):
        self.text = text
        self.toks: List[tuple] = []
        pos = 0
        while pos < len(text):
            m = _TOKEN_RE.match(text, pos)
            if not m or m.end() == pos:
                rest = text[pos:].strip()
                if not rest:
                    break
                raise StatementError(text, f"bad token at {rest[:20]!r}")
            pos = m.end()
            if m.group("str") is not None:
                self.toks.append(("str", m.group("str")))
            elif m.group("punct") is not None:
                self.toks.append(("p", m.group("punct")))
            elif m.group("word") is not None:
                self.toks.append(("w", m.group("word")))
        self.i = 0

    def done(self) -> bool:
        return self.i >= len(self.toks)

    def peek_word(self) -> Optional[str]:
        if self.done():
            return None
        t, v = self.toks[self.i]
        return v.upper() if t == "w" else None

    def take(self) -> tuple:
        if self.done():
            raise StatementError(self.text, "unexpected end of statement")
        tok = self.toks[self.i]
        self.i += 1
        return tok

    def kw(self, *expected: str) -> str:
        t, v = self.take()
        if t != "w" or v.upper() not in expected:
            raise StatementError(
                self.text, f"expected {'/'.join(expected)}, got {v!r}",
                suggest(str(v).upper(), expected))
        return v.upper()

    def opt_kw(self, *words: str) -> Optional[str]:
        if self.peek_word() in words:
            return self.kw(*words)
        return None

    def ident(self, what: str = "name") -> str:
        t, v = self.take()
        if t == "p":
            raise StatementError(self.text, f"expected {what}, got {v!r}")
        return v

    def ref(self) -> str:
        """A ref: quoted string or one bare token."""
        return self.ident("ref")

    def int_(self, what: str = "integer") -> int:
        v = self.ident(what)
        if not v.isdigit():
            raise StatementError(self.text, f"expected {what}, got {v!r}")
        return int(v)

    def name_list(self) -> List[str]:
        """(a, b, c) or a single bare name."""
        if not self.done() and self.toks[self.i] == ("p", "("):
            self.take()
            names = []
            while True:
                t, v = self.take()
                if (t, v) == ("p", ")"):
                    break
                if (t, v) == ("p", ","):
                    continue
                names.append(v)
            return names
        return [self.ident("table name")]

    def end(self) -> None:
        if not self.done():
            _, v = self.toks[self.i]
            raise StatementError(self.text, f"trailing input at {v!r}")


# --------------------------------------------------------------------------
# result rendering
# --------------------------------------------------------------------------

def _fmt_diff(d) -> str:
    plus = int((d.diff_cnt > 0).sum())
    minus = int((d.diff_cnt < 0).sum())
    return (f"{d.n_groups} changed group(s): +{plus}/-{minus} "
            f"(rows scanned {d.stats.rows_scanned:,})")


def _fmt_report(rep) -> str:
    return (f"+{rep.inserted}/-{rep.deleted}"
            + (f", {rep.true_conflicts} conflict(s)"
               if rep.true_conflicts else "")
            + (f" at ts={rep.commit_ts}" if rep.commit_ts else " (no-op)"))


def _fmt_reports(reports: dict) -> str:
    return "; ".join(f"{lg}: {_fmt_report(r)}"
                     for lg, r in sorted(reports.items()))


def _fmt_checks(checks: list) -> str:
    if not checks:
        # user checks are in-process callables (Repo.pr(n).add_check) and
        # do not survive a WAL round-trip — say so, or a fresh process
        # reads "clean" as "all checks passed"
        return ("0 user checks registered (checks are in-process "
                "callables: pr.add_check); merge preview clean")
    bad = [c for c in checks if not c.ok]
    if not bad:
        return f"{len(checks)} check(s) passed"
    return (f"{len(bad)}/{len(checks)} check(s) FAILED: "
            + "; ".join(f"{c.name}: {c.error}" for c in bad))


def _fmt_log(entries: list) -> str:
    if not entries:
        return "(empty history)"
    return "\n".join(f"ts={r.ts:<6} {r.kind:<15} +{r.inserted}/-{r.deleted}"
                     for r in entries)


# one row formatter + label per status section, shared by STATUS and SHOW
_SECTIONS = {
    "tables": ("table", lambda r: f"{r[0]}  head_ts={r[1]} "
                                  f"versions={r[2]}"),
    "branches": ("branch", lambda r: f"{r[0]}  created_ts={r[1]} "
                                     f"tables={','.join(r[2])}"),
    "snapshots": ("snapshot", lambda r: f"{r[0]}  table={r[1]} "
                                        f"created_ts={r[2]}"),
    "prs": ("pr", lambda r: f"#{r[0]}  {r[2]} -> {r[1]}  [{r[3]}]"),
}


def _fmt_status(st: dict) -> str:
    lines = [f"ts={st['ts']}"]
    for section, (label, fmt) in _SECTIONS.items():
        lines += [f"{label} {fmt(r)}" for r in st[section]]
    if "crc32c" in st:
        lines.append(f"crc32c={st['crc32c']}")
    tier = st.get("store")
    if tier is not None:
        lines.append(f"store resident={tier['resident']} "
                     f"packed={tier['packed']} "
                     f"packs={tier['packs'] or '(heap only)'}")
    # the full registry snapshot, zeros included: `datagit status` is how
    # an operator checks the zero-rehash invariant without a debugger
    for k, v in sorted(st.get("metrics", {}).items()):
        lines.append(f"metric {k}={v}")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# statement handlers
# --------------------------------------------------------------------------

def _create(repo, p: _P) -> StatementResult:
    what = p.kw("BRANCH", "SNAPSHOT")
    name = p.ident()
    if what == "BRANCH":
        from_ref = p.ref() if p.opt_kw("FROM") else None
        tables = p.name_list() if p.opt_kw("FOR") else None
        p.end()
        br = repo.branch(name, tables, from_ref)
        return StatementResult(
            "create_branch", br,
            f"branch {br.name} created for ({', '.join(sorted(br.tables))})"
            f" from {from_ref or 'main'}")
    p.kw("FOR")
    p.opt_kw("TABLE")
    table_ref = p.ref()
    p.end()
    snap = repo.tag(name, table_ref)
    return StatementResult(
        "create_snapshot", snap,
        f"snapshot {name} created for table {snap.table} "
        f"at ts={snap.created_ts}")


def _drop(repo, p: _P) -> StatementResult:
    what = p.kw("BRANCH", "SNAPSHOT", "TABLE")
    name = p.ident()
    p.end()
    if what == "BRANCH":
        repo.drop_branch(name)
    elif what == "SNAPSHOT":
        repo.drop_tag(name)
    else:
        repo.drop_table(name)
    return StatementResult(f"drop_{what.lower()}", name,
                           f"{what.lower()} {name} dropped")


def _clone(repo, p: _P) -> StatementResult:
    p.kw("TABLE")
    new = p.ident()
    p.kw("FROM")
    ref = p.ref()
    materialize = p.opt_kw("MATERIALIZE") is not None
    p.end()
    repo.clone(new, ref, materialize=materialize)
    return StatementResult(
        "clone", new,
        f"table {new} cloned from {ref}"
        + (" (materialized)" if materialize else " (metadata-only)"))


def _diff(repo, p: _P) -> StatementResult:
    if p.opt_kw("TABLE"):
        table = p.ident("table name")
        p.kw("AGAINST")
        ref = p.ref()
        p.end()
        d = repo.diff(ref, "HEAD", table=table)
        return StatementResult(
            "diff", d, f"diff {ref} -> {table}@HEAD: {_fmt_diff(d)}")
    a = p.ref()
    p.kw("AGAINST")
    b = p.ref()
    table = None
    if p.opt_kw("FOR"):
        p.opt_kw("TABLE")
        table = p.ident("table name")
    p.end()
    d = repo.diff(a, b, table=table)
    return StatementResult("diff", d, f"diff {a} -> {b}: {_fmt_diff(d)}")


def _merge(repo, p: _P) -> StatementResult:
    if p.opt_kw("BRANCH"):
        head = p.ident("branch name")
        p.kw("INTO")
        base = p.ident("branch name")
        mode = p.ident("mode") if p.opt_kw("MODE") else None
        tables = p.name_list() if p.opt_kw("FOR") else None
        p.end()
        reports = repo.merge(f"branch:{head}", f"branch:{base}",
                             mode=mode, tables=tables)
        return StatementResult(
            "merge", reports,
            f"merged branch {head} into {base}: {_fmt_reports(reports)}")
    src = p.ref()
    p.kw("INTO")
    p.opt_kw("TABLE")
    target = p.ident("table name")
    mode = p.ident("mode") if p.opt_kw("MODE") else None
    p.end()
    rep = repo.merge(src, target, mode=mode)
    return StatementResult(
        "merge", rep, f"merged {src} into {target}: {_fmt_report(rep)}")


def _open(repo, p: _P) -> StatementResult:
    p.kw("PR")
    p.kw("FROM")
    head = p.ident("branch name")
    base = p.ident("branch name") if p.opt_kw("INTO") else None
    p.end()
    pr = repo.open_pr(head, base)
    return StatementResult(
        "open_pr", pr,
        f"PR #{pr.id} opened: {pr.head_name} -> {pr.base_name}")


def _pr_id(p: _P) -> int:
    p.kw("PR")
    return p.int_("PR id")


def _check(repo, p: _P) -> StatementResult:
    n = _pr_id(p)
    p.end()
    checks = repo.check(n)
    return StatementResult("check_pr", checks,
                           f"PR #{n}: {_fmt_checks(checks)}")


def _publish(repo, p: _P) -> StatementResult:
    n = _pr_id(p)
    mode = p.ident("mode") if p.opt_kw("MODE") else None
    p.end()
    reports = repo.publish(n, mode=mode)
    pr = repo.pr(n)
    when = (f"at ts={pr.publish_ts}" if pr.publish_ts is not None
            else "(no changes, no commit)")
    return StatementResult(
        "publish", reports,
        f"PR #{n} published {when}: {_fmt_reports(reports)}")


def _close(repo, p: _P) -> StatementResult:
    n = _pr_id(p)
    p.end()
    repo.close_pr(n)
    return StatementResult("close_pr", n, f"PR #{n} closed")


def _revert(repo, p: _P) -> StatementResult:
    if p.peek_word() == "PR":
        n = _pr_id(p)
        p.end()
        ts = repo.revert_pr(n)
        return StatementResult(
            "revert_pr", ts,
            f"PR #{n} publish reverted"
            + (f" at ts={ts}" if ts else " (no-op)"))
    p.kw("TABLE")
    table = p.ident("table name")
    p.kw("FROM")
    a = p.ref()
    p.kw("TO")
    b = p.ref()
    p.end()
    ts = repo.revert(table, a, b)
    return StatementResult(
        "revert", ts,
        f"table {table}: inverse Δ({a} -> {b}) applied"
        + (f" at ts={ts}" if ts else " (empty Δ, no-op)"))


def _restore(repo, p: _P) -> StatementResult:
    p.kw("TABLE")
    table = p.ident("table name")
    p.kw("TO", "FROM")
    ref = p.ref()
    p.end()
    repo.restore(table, ref)
    return StatementResult("restore", table,
                           f"table {table} restored to {ref}")


def _log(repo, p: _P) -> StatementResult:
    p.opt_kw("TABLE")
    table = p.ref()
    limit = p.int_("limit") if p.opt_kw("LIMIT") else None
    p.end()
    entries = repo.log(table, limit)
    return StatementResult("log", entries,
                           f"log {table}:\n{_fmt_log(entries)}")


def _show(repo, p: _P) -> StatementResult:
    what = p.kw("BRANCHES", "SNAPSHOTS", "PRS", "TABLES").lower()
    p.end()
    rows = repo.status()[what]
    _, fmt = _SECTIONS[what]
    lines = [fmt(r) for r in rows]
    return StatementResult("show", rows,
                           "\n".join(lines) if lines else "(none)")


def _status(repo, p: _P) -> StatementResult:
    p.end()
    st = repo.status()
    return StatementResult("status", st, _fmt_status(st))


def _gc(repo, p: _P) -> StatementResult:
    p.end()
    stats = repo.gc()
    return StatementResult(
        "gc", stats,
        f"gc: freed {stats.objects_freed} object(s), pruned "
        f"{stats.versions_pruned} version(s), "
        f"{stats.pinned_horizons} pinned horizon(s) honored")


def _fsck(repo, p: _P) -> StatementResult:
    repair = p.opt_kw("REPAIR") is not None
    p.end()
    report = repo.fsck(repair=repair)
    lines = [report.summary()] + [str(i) for i in report.issues]
    return StatementResult("fsck", report, "\n".join(lines))


def _lint(repo, p: _P) -> StatementResult:
    """Static invariant analysis of the SOURCE tree (not the repo data) —
    the statement surface of ``datagit lint`` / ``python -m
    repro_torch.analysis``, so statement-driven sessions can gate on it
    too."""
    p.end()
    from ..analysis import (default_paths, discover_count, render_text,
                            repo_root, run_analysis)
    root = repo_root()
    paths = default_paths(root)
    findings = run_analysis(paths, root=root)
    return StatementResult(
        "lint", findings,
        render_text(findings, discover_count(paths)))


def _push(repo, p: _P) -> StatementResult:
    p.kw("TO")
    remote = p.ref()
    p.end()
    st = repo.push(remote)
    return StatementResult(
        "push", st,
        f"push {remote}: {st['objects_pushed']} object(s) "
        f"({st['bytes_pushed']} bytes), {st['records_pushed']} record(s)")


def _pull(repo, p: _P) -> StatementResult:
    p.kw("FROM")
    remote = p.ref()
    p.end()
    st = repo.pull(remote)
    if st.get("up_to_date"):
        return StatementResult("pull", st,
                               f"pull {remote}: already up to date")
    return StatementResult(
        "pull", st,
        f"pull {remote}: {st['objects_pulled']} object(s), "
        f"{st['records_pulled']} record(s)")


def _fetch(repo, p: _P) -> StatementResult:
    p.kw("FROM")
    remote = p.ref()
    p.end()
    st = repo.fetch(remote)
    return StatementResult(
        "fetch", st,
        f"fetch {remote}: {st['objects_pulled']} object(s) "
        f"({st['bytes_pulled']} bytes)")


def _stats(repo, p: _P) -> StatementResult:
    p.end()
    doc = telemetry.stats_json(repo.engine)
    lines = [f"{k}={v}" for k, v in doc["metrics"].items()]
    return StatementResult("stats", doc, "\n".join(lines))


def _explain(repo, p: _P) -> StatementResult:
    """EXPLAIN <statement>: run the wrapped statement under the tracer and
    print its span tree + counter deltas. The span renderer shows the
    zero-valued siblings of every touched counter group, so the pinned
    invariants read directly off the output (``EXPLAIN MERGE ...`` shows
    ``commit.rows_rehashed=0``)."""
    t, v = p.take()
    verb = v.upper() if t == "w" else v
    handler = _HANDLERS.get(verb)
    if handler is None or verb == "EXPLAIN":
        raise StatementError(
            p.text, f"EXPLAIN: unknown statement verb {v!r}",
            suggest(verb, tuple(x for x in _VERBS if x != "EXPLAIN")))
    if telemetry.current() is None:
        with telemetry.trace(repo.engine) as tr:
            inner = handler(repo, p)
        spans = tr.roots
    else:
        # already armed (e.g. `datagit --trace` running an EXPLAIN): nest
        # the statement's spans under one explain span instead of
        # re-arming
        with telemetry.span(SP_EXPLAIN) as sp:
            inner = handler(repo, p)
        spans = sp.children
    tree = telemetry.render_spans(spans)
    body = "\n".join(tree) if tree else "(no spans recorded)"
    return StatementResult(
        "explain", {"result": inner, "spans": spans},
        (inner.message + "\n" if inner.message else "") + body)


_HANDLERS = {
    "CREATE": _create, "DROP": _drop, "CLONE": _clone, "DIFF": _diff,
    "MERGE": _merge, "OPEN": _open, "CHECK": _check, "PUBLISH": _publish,
    "CLOSE": _close, "REVERT": _revert, "RESTORE": _restore, "LOG": _log,
    "SHOW": _show, "STATUS": _status, "STATS": _stats,
    "EXPLAIN": _explain, "GC": _gc, "FSCK": _fsck,
    "LINT": _lint, "PUSH": _push, "PULL": _pull, "FETCH": _fetch,
}
_VERBS = tuple(_HANDLERS)        # one source of truth for did-you-mean


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def execute(repo, text: str) -> StatementResult:
    """Parse and run ONE statement against a :class:`~.repo.Repo`."""
    stmts = [s for s in text.split(";") if s.strip()]
    if len(stmts) != 1:
        raise StatementError(text, f"expected one statement, got "
                             f"{len(stmts)} (use execute_script)")
    p = _P(stmts[0])
    t, v = p.take()
    verb = v.upper() if t == "w" else v
    handler = _HANDLERS.get(verb)
    if handler is None:
        raise StatementError(text, f"unknown statement verb {v!r}",
                             suggest(verb, _VERBS))
    return handler(repo, p)


def execute_script(repo, text: str) -> List[StatementResult]:
    """Run a ``;``-separated sequence of statements, in order."""
    return [execute(repo, s) for s in text.split(";") if s.strip()]
