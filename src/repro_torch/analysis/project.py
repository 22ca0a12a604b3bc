"""Cross-module facts the rules need: crash registry vs call sites, the
WAL kind set, and the replay dispatch table.

The port's copy of ``repro.analysis.project``, keyed to the port's WAL,
engine and telemetry modules. The port's crash points keep their own
``torch.`` names (and ``CP_TORCH_*`` constants), so a tree that holds both
packages registers each seam once.

Collected in two passes over every scanned module so rules stay local:
pass 1 binds ``CP_X = register("name", ...)`` constants (they are imported
across modules under the same names), pass 2 resolves ``crash_point(...)``
arguments against those bindings.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .base import LintModule, attr_chain, const_str

WAL_MODULE = "repro_torch.core.wal"
ENGINE_MODULE = "repro_torch.core.engine"
#: the one repro_torch.core module allowed to read clocks (spans live here;
#: the wal-hygiene clock check allowlists it)
TELEMETRY_MODULE = "repro_torch.core.telemetry"


class Project:
    """Facts shared by every rule for one analysis run."""

    def __init__(self, modules: List[LintModule]):
        self.modules = modules
        self.by_module: Dict[str, LintModule] = {m.module: m for m in modules}
        #: crash-point name -> (rel path, line) of its register() call
        self.crash_registry: Dict[str, Tuple[str, int]] = {}
        #: constant name (CP_WAL_APPEND) -> crash-point name ("wal.append")
        self.crash_consts: Dict[str, str] = {}
        #: crash-point name -> [(rel path, line)] of crash_point() calls
        self.crash_calls: Dict[str, List[Tuple[str, int]]] = {}
        #: crash_point() calls whose argument could not be resolved
        #: statically: (module, node, source repr)
        self.unresolved_crash_calls: List[Tuple[LintModule, ast.Call, str]] \
            = []
        #: record kinds WAL.append accepts (the KINDS frozenset literal)
        self.wal_kinds: Set[str] = set()
        self.wal_kinds_line: int = 0
        #: record kinds Engine.replay dispatches on
        self.replay_kinds: Set[str] = set()
        self.replay_line: int = 0
        self._collect()

    # ------------------------------------------------------------ pass 1
    def _collect(self) -> None:
        for mod in self.modules:
            if mod.tree is None:
                continue
            self._collect_registry(mod)
            if mod.module == WAL_MODULE:
                self._collect_wal_kinds(mod)
            if mod.module == ENGINE_MODULE:
                self._collect_replay_kinds(mod)
        for mod in self.modules:
            if mod.tree is not None:
                self._collect_crash_calls(mod)

    def _collect_registry(self, mod: LintModule) -> None:
        for node in ast.walk(mod.tree):
            call: Optional[ast.Call] = None
            targets: List[ast.expr] = []
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call):
                call, targets = node.value, node.targets
            elif (isinstance(node, ast.Expr)
                    and isinstance(node.value, ast.Call)):
                call = node.value
            if call is None:
                continue
            chain = attr_chain(call.func)
            if not chain or chain[-1] != "register":
                continue
            if not call.args:
                continue
            name = const_str(call.args[0])
            if name is None:
                continue
            self.crash_registry.setdefault(name, (mod.rel, call.lineno))
            for t in targets:
                if isinstance(t, ast.Name):
                    self.crash_consts[t.id] = name

    def _collect_crash_calls(self, mod: LintModule) -> None:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            if not chain or chain[-1] != "crash_point":
                continue
            if not node.args:
                continue
            arg = node.args[0]
            name = const_str(arg)
            if name is None and isinstance(arg, ast.Name):
                name = self.crash_consts.get(arg.id)
            if name is None:
                self.unresolved_crash_calls.append(
                    (mod, node, ast.dump(arg)))
                continue
            self.crash_calls.setdefault(name, []).append(
                (mod.rel, node.lineno))

    # ------------------------------------------------------ WAL / replay
    def _collect_wal_kinds(self, mod: LintModule) -> None:
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "KINDS"):
                continue
            self.wal_kinds_line = node.lineno
            for sub in ast.walk(node.value):
                s = const_str(sub)
                if s is not None:
                    self.wal_kinds.add(s)

    def _collect_replay_kinds(self, mod: LintModule) -> None:
        # the dispatch loop may live in ``replay`` itself or in a
        # ``_replay*`` helper it delegates to (the public wrapper opens a
        # telemetry span and resets metrics) — scan both, union the kinds
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.FunctionDef)
                    and (node.name == "replay"
                         or node.name.startswith("_replay"))):
                continue
            if node.name == "replay":
                self.replay_line = node.lineno
            for sub in ast.walk(node):
                if isinstance(sub, ast.Compare):
                    # only DIRECT string operands: `k == "commit"`.
                    # Walking deeper would pick up subscript keys
                    # (p["ts"]) that are not dispatch kinds.
                    for cand in [sub.left, *sub.comparators]:
                        s = const_str(cand)
                        if s is not None:
                            self.replay_kinds.add(s)
