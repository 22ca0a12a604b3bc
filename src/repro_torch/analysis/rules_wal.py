"""WAL/replay hygiene pass.

The port's copy of ``repro.analysis.rules_wal``, keyed to
``repro_torch.core`` and taught torch's RNG. The WAL is the single source
of truth at recovery: a record kind nobody
replays is data loss, and a logging function that consults wall-clock
time or an RNG makes replay non-deterministic (replay re-executes the
logged operations — any nondeterministic input diverges the rebuilt
engine from the one that crashed).

Checks:

* every ``*.wal.append("kind", ...)`` site uses a string-literal kind
  that is both in ``wal.KINDS`` and dispatched by ``Engine.replay``;
* the ``KINDS`` set and the replay dispatch table agree exactly (a kind
  in one but not the other is reported once, at the owning module);
* a function that appends WAL records must not call time/RNG sources
  (``time.*``, ``datetime.now``, ``random.*``, ``np.random.*``,
  ``secrets``, ``uuid``, and torch's own: ``torch.rand``, ``randn``,
  ``randint``, ``randperm``, ``normal``, ``manual_seed``, ``seed``, the
  ``torch.random``/``torch.cuda`` forms of them, and a
  ``torch.Generator`` that is not seeded where it is made);
* no ``repro_torch.core`` module reads clocks at all, except
  ``core.telemetry``: the span tracer is the one sanctioned
  home for ``perf_counter`` — timings that originate anywhere else in
  the core can leak into WAL payloads or derived state and diverge
  replay.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from .base import Finding, LintModule, Rule, attr_chain, call_chain, \
    const_str
from .project import ENGINE_MODULE, TELEMETRY_MODULE, WAL_MODULE

#: call chains whose presence in a WAL-appending function breaks replay
#: determinism (matched on the first element + any tail)
_NONDET_HEADS = frozenset({"random", "secrets", "uuid"})
_NONDET_TIME = frozenset({"time", "time_ns", "monotonic", "monotonic_ns",
                          "perf_counter", "perf_counter_ns", "now",
                          "utcnow", "today"})
#: torch's draws from (or reseeds of) a global generator
_TORCH_RNG = frozenset({"rand", "randn", "randint", "randperm", "normal",
                        "manual_seed", "seed", "rand_like", "randn_like",
                        "randint_like", "bernoulli", "multinomial"})


def _wal_append_calls(node: ast.AST) -> List[ast.Call]:
    out = []
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        chain = call_chain(sub)
        if len(chain) >= 2 and chain[-1] == "append" and chain[-2] == "wal":
            out.append(sub)
    return out


def _seeded_generators(node: ast.AST) -> set:
    """ids of ``torch.Generator(...)`` calls seeded where they are made:
    ``torch.Generator(...).manual_seed(s)``."""
    out = set()
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "manual_seed"
                and isinstance(sub.func.value, ast.Call)):
            out.add(id(sub.func.value))
    return out


def _torch_rng(call: ast.Call, chain: List[str], seeded: set) -> bool:
    if len(chain) < 2 or chain[0] != "torch":
        return False
    if chain[1] == "random" or chain[-1] in _TORCH_RNG:
        return True
    return chain[-1] == "Generator" and id(call) not in seeded


def _nondet_call(node: ast.AST) -> Optional[ast.Call]:
    seeded = _seeded_generators(node)
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        chain = call_chain(sub)
        if not chain:
            continue
        if chain[0] in _NONDET_HEADS:
            return sub
        if len(chain) >= 2 and chain[0] in ("np", "numpy") \
                and chain[1] == "random":
            return sub
        if _torch_rng(sub, chain, seeded):
            return sub
        if len(chain) >= 2 and chain[0] in ("time", "datetime") \
                and chain[-1] in _NONDET_TIME:
            return sub
    return None


def _clock_calls(tree: ast.AST) -> List[ast.Call]:
    """Every ``time.*``/``datetime.*`` clock read in the tree (the
    module-wide check — RNG is left to the per-function WAL pass)."""
    out = []
    for sub in ast.walk(tree):
        if not isinstance(sub, ast.Call):
            continue
        chain = call_chain(sub)
        if len(chain) >= 2 and chain[0] in ("time", "datetime") \
                and chain[-1] in _NONDET_TIME:
            out.append(sub)
    return out


class WalHygieneRule(Rule):
    id = "wal-hygiene"
    pragma = "wal-ok"
    doc = ("WAL-append sites must log literal kinds known to KINDS and the "
           "replay dispatch, and WAL-appending functions must be replay-"
           "deterministic (no time/RNG)")

    def check(self, mod: LintModule, project) -> List[Finding]:
        if mod.tree is None:
            return []
        out: List[Finding] = []
        if mod.module == WAL_MODULE and project.replay_kinds:
            for kind in sorted(project.wal_kinds - project.replay_kinds):
                out.append(Finding(
                    rule=self.id, path=mod.rel,
                    line=project.wal_kinds_line, col=0,
                    message=f"KINDS contains {kind!r} but Engine.replay "
                            "never dispatches it — records of this kind "
                            "are silently lost at recovery",
                    hint="add a replay arm or drop the kind"))
        if mod.module == ENGINE_MODULE and project.wal_kinds:
            for kind in sorted(project.replay_kinds - project.wal_kinds):
                out.append(Finding(
                    rule=self.id, path=mod.rel, line=project.replay_line,
                    col=0,
                    message=f"Engine.replay dispatches {kind!r} which "
                            "WAL.append would reject (not in KINDS)",
                    hint="add the kind to wal.KINDS or drop the dead arm"))
        funcs = [n for n in ast.walk(mod.tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        seen_calls = set()
        flagged_nondet = set()
        for fn in funcs:
            appends = [c for c in _wal_append_calls(fn)
                       if id(c) not in seen_calls]
            if not appends:
                continue
            seen_calls.update(id(c) for c in appends)
            for call in appends:
                kind = const_str(call.args[0]) if call.args else None
                if kind is None:
                    out.append(self.finding(
                        mod, call,
                        f"{fn.name}() appends a WAL record with a non-"
                        "literal kind — replay reachability cannot be "
                        "checked statically",
                        "pass the kind as a string literal"))
                    continue
                if project.wal_kinds and kind not in project.wal_kinds:
                    out.append(self.finding(
                        mod, call,
                        f"{fn.name}() logs unknown WAL kind {kind!r} "
                        "(not in wal.KINDS)"))
                elif project.replay_kinds \
                        and kind not in project.replay_kinds:
                    out.append(self.finding(
                        mod, call,
                        f"{fn.name}() logs WAL kind {kind!r} that "
                        "Engine.replay never dispatches — unrecoverable "
                        "at crash time"))
            nondet = _nondet_call(fn)
            if nondet is not None:
                flagged_nondet.add(id(nondet))
                src = ".".join(attr_chain(nondet.func)) or "<call>"
                out.append(self.finding(
                    mod, nondet,
                    f"{fn.name}() appends WAL records AND calls {src} — "
                    "time/RNG in a logging function breaks replay "
                    "determinism",
                    "hoist the nondeterminism out (log its result as "
                    "payload) or justify with `# lint: wal-ok <reason>`"))
        if mod.module.startswith("repro_torch.core.") \
                and mod.module != TELEMETRY_MODULE:
            # the clock lives in core.telemetry and ONLY there — a core
            # module that reads time can leak it into WAL payloads or
            # derived state, diverging replay (skip calls the WAL pass
            # above already reported)
            for call in _clock_calls(mod.tree):
                if id(call) in flagged_nondet:
                    continue
                src = ".".join(attr_chain(call.func)) or "<call>"
                out.append(self.finding(
                    mod, call,
                    f"core module calls {src} — clocks belong to "
                    f"{TELEMETRY_MODULE} (span timings), nowhere else "
                    "in repro_torch.core",
                    "open a telemetry span instead, or justify with "
                    "`# lint: wal-ok <reason>`"))
        return out
