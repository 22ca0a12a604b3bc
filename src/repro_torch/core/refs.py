"""One ref grammar, one resolver.

The port's copy of ``repro.core.refs``: every way to name a version parses
into one small AST and resolves through ONE path. Grammar (canonical
forms on the left)::

    HEAD                 current state of the context table
    branch:dev           branch by name
    snap:nightly         named snapshot (a git tag)
    ts:12345             PITR horizon of the context table (T{mo_ts = ts})
    orders@{12345}       PITR horizon of a named table (no context needed)
    orders~2             2 commits back in the table's PITR history index
    pr:3:base            PR #3's pinned base-at-open horizon
    dev                  bare name: branch, snapshot, or table head —
                         ambiguity is an error, never a guess

Branches and pull requests live in ``workspace``; the resolver imports it
lazily (workspace imports this module).
"""
from __future__ import annotations

import difflib
import re
from dataclasses import dataclass
from typing import Optional, Sequence, Union

from .directory import Snapshot

PR_ROLES = ("base", "head", "merged")

_NAME = r"[A-Za-z_][A-Za-z0-9_.\-/]*"
_NAME_RE = re.compile(rf"^{_NAME}$")
_AT_RE = re.compile(rf"^(?P<table>{_NAME})@\{{(?P<ts>\d+)\}}$")
_REL_RE = re.compile(rf"^(?P<table>{_NAME})~(?P<n>\d+)$")


# --------------------------------------------------------------------------
# errors
# --------------------------------------------------------------------------

class RefSyntaxError(ValueError):
    """The ref text does not parse under the grammar."""

    def __init__(self, text: str, why: str):
        super().__init__(f"bad ref {text!r}: {why}")
        self.ref = text


def did_you_mean(suggestions: Sequence[str]) -> str:
    """The one rendering of a suggestion list (shared with the statement
    layer's errors)."""
    if not suggestions:
        return ""
    return (" — did you mean "
            + " or ".join(repr(s) for s in suggestions) + "?")


class UnknownRefError(KeyError):
    """A syntactically valid ref that names nothing.

    Subclasses ``KeyError`` so legacy callers (``engine.snapshots[...]``
    era) keep working; carries the offending ref text and did-you-mean
    suggestions for the porcelain surfaces to render."""

    def __init__(self, ref: str, why: str = "no such ref",
                 suggestions: Sequence[str] = ()):
        super().__init__(f"{ref}: {why}{did_you_mean(suggestions)}")
        self.ref = ref
        self.suggestions = tuple(suggestions)

    def __str__(self) -> str:
        # KeyError's default __str__ is repr(args[0]) — spurious quotes
        # around the message; keep the one consistent error shape
        return self.args[0] if self.args else ""


class AmbiguousRefError(ValueError):
    """A bare name with more than one legal reading."""

    def __init__(self, ref: str, candidates: Sequence[str]):
        super().__init__(
            f"ambiguous ref {ref!r}: could be " + " or ".join(
                repr(c) for c in candidates)
            + " — qualify it")
        self.ref = ref
        self.suggestions = tuple(candidates)


def validate_name(name: str, what: str = "name") -> str:
    """Creation-side guard: a snapshot/branch name must be speakable in
    the ref grammar, or the object could never be named again through any
    surface (resolve/statements/CLI all parse refs first)."""
    if not isinstance(name, str) or not _NAME_RE.match(name):
        raise ValueError(
            f"invalid {what} {name!r}: must start with a letter/underscore "
            "and contain only letters, digits, and _ . - / "
            "(the ref grammar has to be able to name it)")
    return name


def require(mapping, name: str, what: str, ref_text: Optional[str] = None):
    """Lookup with the one error shape: UnknownRefError + did-you-mean.
    Collapses the ``if name not in ...: raise`` guard every porcelain
    entry point needs."""
    if name not in mapping:
        raise UnknownRefError(ref_text or name, f"no {what} {name!r}",
                              suggest(name, mapping))
    return mapping[name]


def suggest(name: str, candidates) -> list:
    """Did-you-mean candidates: close matches first, then shared prefixes."""
    pool = sorted(set(map(str, candidates)))
    out = difflib.get_close_matches(name, pool, n=3, cutoff=0.5)
    for c in pool:
        if len(out) >= 3:
            break
        if c not in out and (c.startswith(name[:3]) if name else False):
            out.append(c)
    return out


# --------------------------------------------------------------------------
# AST
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Ref:
    """Base class; every concrete form knows its canonical text."""

    def format(self) -> str:
        raise NotImplementedError


@dataclass(frozen=True)
class HeadRef(Ref):
    def format(self) -> str:
        return "HEAD"


@dataclass(frozen=True)
class BranchRef(Ref):
    name: str

    def format(self) -> str:
        return f"branch:{self.name}"


@dataclass(frozen=True)
class SnapRef(Ref):
    name: str

    def format(self) -> str:
        return f"snap:{self.name}"


@dataclass(frozen=True)
class TsRef(Ref):
    ts: int

    def format(self) -> str:
        return f"ts:{self.ts}"


@dataclass(frozen=True)
class AtRef(Ref):
    table: str
    ts: int

    def format(self) -> str:
        return f"{self.table}@{{{self.ts}}}"


@dataclass(frozen=True)
class RelRef(Ref):
    table: str
    n: int

    def format(self) -> str:
        return f"{self.table}~{self.n}"


@dataclass(frozen=True)
class PrRef(Ref):
    pr_id: int
    role: str                       # base | head | merged

    def format(self) -> str:
        return f"pr:{self.pr_id}:{self.role}"


@dataclass(frozen=True)
class BareRef(Ref):
    """A bare name: branch, snapshot, or table head — resolved by lookup,
    ambiguity is an error."""
    name: str

    def format(self) -> str:
        return self.name


@dataclass(frozen=True)
class ResolvedRef:
    """What every ref resolves to: a physical table + a frozen snapshot."""
    ref: Optional[Ref]              # None when resolved from a Snapshot
    table: str                      # physical table name
    snapshot: Snapshot


RefLike = Union[str, Ref, Snapshot]


# --------------------------------------------------------------------------
# parser
# --------------------------------------------------------------------------

def parse_ref(text: str) -> Ref:
    """Parse ref text into its AST form. Raises RefSyntaxError."""
    if not isinstance(text, str):
        raise RefSyntaxError(str(text), f"expected a string, got "
                             f"{type(text).__name__}")
    t = text.strip()
    if not t:
        raise RefSyntaxError(text, "empty ref")
    if t == "HEAD":
        return HeadRef()
    for prefix, cls in (("branch:", BranchRef), ("snap:", SnapRef)):
        if t.startswith(prefix):
            name = t[len(prefix):]
            if not _NAME_RE.match(name):
                raise RefSyntaxError(text, f"invalid name {name!r}")
            return cls(name)
    if t.startswith("ts:"):
        body = t[3:]
        if not body.isdigit():
            raise RefSyntaxError(text, "ts: needs an integer timestamp")
        return TsRef(int(body))
    if t.startswith("pr:"):
        parts = t.split(":")
        if len(parts) not in (2, 3) or not parts[1].isdigit():
            raise RefSyntaxError(text, "expected pr:<id>[:base|head|merged]")
        role = parts[2] if len(parts) == 3 else "head"
        if role not in PR_ROLES:
            raise RefSyntaxError(
                text, f"bad PR role {role!r} (one of {'/'.join(PR_ROLES)})")
        return PrRef(int(parts[1]), role)
    m = _AT_RE.match(t)
    if m:
        return AtRef(m.group("table"), int(m.group("ts")))
    m = _REL_RE.match(t)
    if m:
        return RelRef(m.group("table"), int(m.group("n")))
    if _NAME_RE.match(t):
        return BareRef(t)
    raise RefSyntaxError(text, "unrecognized form")


def format_ref(ref: Ref) -> str:
    return ref.format()


# --------------------------------------------------------------------------
# the one resolver
# --------------------------------------------------------------------------

def _table_snapshot(engine, phys: str, ref_text: str) -> Snapshot:
    if phys not in engine.tables:
        raise UnknownRefError(ref_text, f"no table {phys!r}",
                              suggest(phys, engine.tables))
    return engine.current_snapshot(phys)


def _branch(engine, name: str, ref_text: str):
    """Branch lookup with trunk synthesis; UnknownRefError otherwise."""
    # lint: legacy-ok the resolver IS resolve_branch's sanctioned caller
    from .workspace import TRUNK, resolve_branch
    if name == TRUNK or name in engine.branches:
        return resolve_branch(engine, name)  # lint: legacy-ok as above
    raise UnknownRefError(
        ref_text, f"no branch {name!r}",
        suggest(name, list(engine.branches) + [TRUNK]))


def _branch_table(engine, br, table: Optional[str], ref_text: str) -> str:
    if table is None:
        raise UnknownRefError(
            ref_text, "branch ref needs a table context (pass table=...)",
            [f"{ref_text} with table={t!r}" for t in sorted(br.tables)[:2]])
    if table in br.tables:
        return br.tables[table]
    # accept the branch's own physical names too (dev/t on branch dev)
    if table in br.tables.values():
        return table
    raise UnknownRefError(
        ref_text, f"branch {br.name!r} has no table {table!r}",
        suggest(table, br.tables))


def _pitr_snapshot(engine, phys: str, ts: int, ref_text: str) -> Snapshot:
    if phys not in engine.tables:
        raise UnknownRefError(ref_text, f"no table {phys!r}",
                              suggest(phys, engine.tables))
    t = engine.table(phys)
    try:
        d = t.directory_at(ts)
    except KeyError:
        raise UnknownRefError(
            ref_text, f"no PITR history for {phys!r} at ts={ts} "
            f"(history starts at ts={t.history[0][0]})") from None
    return Snapshot(name=None, table=phys, schema=t.schema, directory=d,
                    created_ts=ts)


def _pr(engine, pr_id: int, ref_text: str):
    pr = engine.prs.get(pr_id)
    if pr is None:
        raise UnknownRefError(
            ref_text, f"no PR #{pr_id}",
            [f"pr:{i}" for i in sorted(engine.prs)][:3])
    return pr


def resolve(engine, ref: RefLike, table: Optional[str] = None) -> ResolvedRef:
    """THE resolution path: every porcelain surface funnels through here.

    ``ref`` may be a ``Snapshot`` (passes through), ref text, or a parsed
    ``Ref``. ``table`` is the logical table context required by the forms
    that do not name a table themselves (HEAD, branch refs, ts:, pr:).
    Raises ``UnknownRefError`` / ``AmbiguousRefError`` / ``RefSyntaxError``.
    """
    if isinstance(ref, Snapshot):
        return ResolvedRef(None, ref.table, ref)
    r = parse_ref(ref) if isinstance(ref, str) else ref
    if not isinstance(r, Ref):
        raise RefSyntaxError(str(ref), f"not a ref: {type(ref).__name__}")
    text = r.format()

    if isinstance(r, HeadRef):
        if table is None:
            raise UnknownRefError(text, "HEAD needs a table context "
                                  "(pass table=...)")
        snap = _table_snapshot(engine, table, text)
        return ResolvedRef(r, table, snap)

    if isinstance(r, BranchRef):
        br = _branch(engine, r.name, text)
        phys = _branch_table(engine, br, table, text)
        return ResolvedRef(r, phys, engine.current_snapshot(phys))

    if isinstance(r, SnapRef):
        snap = engine.snapshots.get(r.name)
        if snap is None:
            raise UnknownRefError(text, f"no snapshot {r.name!r}",
                                  suggest(r.name, engine.snapshots))
        return ResolvedRef(r, snap.table, snap)

    if isinstance(r, TsRef):
        if table is None:
            raise UnknownRefError(text, "ts: ref needs a table context "
                                  "(pass table=..., or use table@{ts})")
        return ResolvedRef(r, table, _pitr_snapshot(engine, table, r.ts,
                                                    text))

    if isinstance(r, AtRef):
        return ResolvedRef(r, r.table, _pitr_snapshot(engine, r.table,
                                                      r.ts, text))

    if isinstance(r, RelRef):
        if r.table not in engine.tables:
            raise UnknownRefError(text, f"no table {r.table!r}",
                                  suggest(r.table, engine.tables))
        t = engine.table(r.table)
        if r.n >= len(t.history):
            raise UnknownRefError(
                text, f"only {len(t.history)} version(s) in "
                f"{r.table!r}'s history index")
        ts, d = t.history[len(t.history) - 1 - r.n]
        snap = Snapshot(name=None, table=r.table, schema=t.schema,
                        directory=d, created_ts=ts)
        return ResolvedRef(r, r.table, snap)

    if isinstance(r, PrRef):
        pr = _pr(engine, r.pr_id, text)
        if table is not None:
            if table not in pr.tables:
                raise UnknownRefError(
                    text, f"PR #{r.pr_id} does not cover table {table!r}",
                    suggest(table, pr.tables))
            lg = table
        elif len(pr.tables) == 1:
            lg = next(iter(pr.tables))
        else:
            raise AmbiguousRefError(
                text, [f"{text} with table={t!r}"
                       for t in sorted(pr.tables)])
        if r.role == "base":
            snap = pr.base_pins[lg]
            return ResolvedRef(r, snap.table, snap)
        if r.role == "head":
            phys = pr.tables[lg]
            return ResolvedRef(r, phys, _table_snapshot(engine, phys, text))
        snap = pr.post_publish.get(lg)     # merged
        if snap is None:
            raise UnknownRefError(
                text, f"PR #{r.pr_id} is {pr.status}: no merged state "
                "(publish it first)")
        return ResolvedRef(r, snap.table, snap)

    if isinstance(r, BareRef):
        from .workspace import TRUNK
        readings = []
        if r.name == TRUNK or r.name in engine.branches:
            readings.append(("branch", BranchRef(r.name)))
        if r.name in engine.snapshots:
            readings.append(("snapshot", SnapRef(r.name)))
        if r.name in engine.tables:
            readings.append(("table", None))
        if len(readings) > 1:
            raise AmbiguousRefError(
                text, [f"branch:{r.name}" if k == "branch"
                       else f"snap:{r.name}" if k == "snapshot"
                       else f"{r.name}@{{ts}} / HEAD of table {r.name!r}"
                       for k, _ in readings])
        if not readings:
            pool = (list(engine.branches) + list(engine.snapshots)
                    + list(engine.tables) + [TRUNK])
            raise UnknownRefError(
                text, "no branch, snapshot, or table by that name",
                suggest(r.name, pool))
        kind, sub = readings[0]
        if kind == "table":
            return ResolvedRef(r, r.name,
                               engine.current_snapshot(r.name))
        return resolve(engine, sub, table)

    raise RefSyntaxError(text, "unhandled ref form")   # pragma: no cover


def as_branch(engine, ref: RefLike):
    """The Branch a ref denotes, or None if it isn't a branch ref.

    ``branch:x`` raises UnknownRefError if x doesn't exist; a bare name
    returns the branch only when that reading is unambiguous."""
    from .workspace import TRUNK
    if isinstance(ref, Snapshot):
        return None
    r = parse_ref(ref) if isinstance(ref, str) else ref
    if isinstance(r, BranchRef):
        return _branch(engine, r.name, r.format())
    if isinstance(r, BareRef):
        is_branch = r.name == TRUNK or r.name in engine.branches
        if is_branch:
            others = []
            if r.name in engine.snapshots:
                others.append(f"snap:{r.name}")
            if r.name in engine.tables:
                others.append(f"table {r.name!r}")
            if others:
                raise AmbiguousRefError(
                    r.format(), [f"branch:{r.name}"] + others)
            return _branch(engine, r.name, r.format())
    return None
