"""Crash-point coverage pass (the fault-injection contract).

The port's copy of ``repro.analysis.rules_crash``; nothing in it is keyed
to a package. Cross-checks the ``core.faults`` registry against real ``crash_point``
call sites, and enforces the seam-placement discipline:

* every registered name is called somewhere (a registered-but-never-hit
  seam gives the crash sweep false confidence);
* every ``crash_point`` argument resolves to a registered name;
* every ``os.fsync`` site and every multi-/looped directory swing sits in
  a function that also marks a crash point (the durability seams the
  sweep must be able to kill);
* no bare ``except:``/``except BaseException`` without re-raise — and no
  ``except Exception`` — lexically encloses a crash-point seam, where it
  reads like (or is) an InjectedCrash swallow.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from .base import Finding, LintModule, Rule, attr_chain, call_chain


def _has_call(node: ast.AST, tail: str) -> Optional[ast.Call]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            chain = call_chain(sub)
            if chain and chain[-1] == tail:
                return sub
    return None


def _fsync_calls(node: ast.AST) -> List[ast.Call]:
    out = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            chain = call_chain(sub)
            if chain and chain[-1] == "fsync":
                out.append(sub)
    return out


def _swing_calls(node: ast.AST) -> List[ast.Call]:
    out = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            chain = call_chain(sub)
            if chain and chain[-1] == "set_directory":
                out.append(sub)
    return out


def _in_loop(func: ast.AST, target: ast.Call) -> bool:
    for sub in ast.walk(func):
        if isinstance(sub, (ast.For, ast.While)):
            for inner in ast.walk(sub):
                if inner is target:
                    return True
    return False


def _handler_reraises(handler: ast.ExceptHandler) -> bool:
    for sub in ast.walk(handler):
        if isinstance(sub, ast.Raise):
            return True
    return False


class CrashCoverageRule(Rule):
    id = "crash-coverage"
    pragma = "crash-ok"
    doc = ("cross-check of the core.faults registry vs crash_point call "
           "sites; fsync/directory-swing seams must be guarded; no broad "
           "except may enclose a crash-point seam")

    def check(self, mod: LintModule, project) -> List[Finding]:
        if mod.tree is None:
            return []
        out: List[Finding] = []
        # registry entries with no call site, reported at the register()
        for name, (rel, line) in sorted(project.crash_registry.items()):
            if rel != mod.rel:
                continue
            if not project.crash_calls.get(name):
                out.append(Finding(
                    rule=self.id, path=mod.rel, line=line, col=0,
                    message=f"crash point {name!r} is registered but never "
                            "marked with crash_point() anywhere",
                    hint="call crash_point at the seam (or remove the "
                         "registration) so the crash sweep can reach it"))
        # crash_point args that resolve to nothing
        for m, node, repr_ in project.unresolved_crash_calls:
            if m is mod:
                out.append(self.finding(
                    mod, node,
                    "crash_point() argument is not a registered name or a "
                    "CP_* constant bound by register() — the sweep cannot "
                    "enumerate this seam",
                    "bind the name via `CP_X = register(...)` and pass "
                    "CP_X"))
        for name, sites in project.crash_calls.items():
            if name in project.crash_registry:
                continue
            for rel, line in sites:
                if rel == mod.rel:
                    out.append(Finding(
                        rule=self.id, path=mod.rel, line=line, col=0,
                        message=f"crash_point({name!r}) names an "
                                "unregistered crash point",
                        hint="register() it at import time so "
                             "registered() enumerates the seam"))
        # seam-placement checks, per function
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            guarded = _has_call(node, "crash_point") is not None
            if not guarded:
                for call in _fsync_calls(node):
                    out.append(self.finding(
                        mod, call,
                        f"os.fsync in {node.name}() without a crash_point "
                        "seam — the crash sweep cannot kill the process at "
                        "this durability boundary"))
                swings = _swing_calls(node)
                if len(swings) > 1 or any(_in_loop(node, s) for s in swings):
                    out.append(self.finding(
                        mod, swings[0],
                        f"{node.name}() swings multiple directories "
                        "without a crash_point between swings — a mid-"
                        "swing crash is unreachable by the sweep"))
        # broad excepts around seams
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Try):
                continue
            body_block = ast.Module(body=node.body, type_ignores=[])
            seam = (_has_call(body_block, "crash_point")
                    or _fsync_calls(body_block))
            if not seam:
                continue
            for handler in node.handlers:
                broad = handler.type is None or (
                    attr_chain(handler.type)[-1:] in (["BaseException"],
                                                      ["Exception"]))
                if broad and not _handler_reraises(handler):
                    what = ("bare except" if handler.type is None
                            else f"except {attr_chain(handler.type)[-1]}")
                    out.append(self.finding(
                        mod, handler,
                        f"{what} without re-raise encloses a crash-point/"
                        "fsync seam — an InjectedCrash (or real failure) "
                        "unwind can be masked here",
                        "narrow the except, re-raise, or justify with "
                        "`# lint: crash-ok <why the seam is safe>`"))
        return out
