"""Deprecation-map enforcement, call-graph-aware.

The port's copy of ``repro.analysis.rules_deprecation``: the shim modules
that may keep touching a deprecated name are the port's own.

Replaces the old CI ``grep -E '\\.(name)\\('`` step, which missed::

    f = engine.resolve_snapshot      # aliasing, called later
    getattr(engine, "resolve_snapshot")(ref)
    from .engine import resolve_snapshot as rs   # import aliasing

This pass flags ANY load of a deprecated name — attribute access, bare
name, getattr-with-literal, and import aliasing — outside the modules
that define the shims. Definitions themselves (``def resolve_snapshot``)
are not loads and stay clean.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set

from .base import Finding, LintModule, Rule, call_chain, const_str

#: deprecated name -> (replacement hint, modules allowed to touch it)
DEPRECATION_MAP: Dict[str, tuple] = {
    "resolve_snapshot": (
        "repo.resolve('snap:<name>') / refs.resolve — the one ref grammar",
        frozenset({"repro_torch.core.engine"})),
    "snapshot_at": (
        "repo.resolve('<table>@{ts}')",
        frozenset({"repro_torch.core.engine"})),
    "resolve_branch": (
        "refs.as_branch(engine, 'branch:<name>') (resolve_branch is "
        "internal to the resolver)",
        frozenset({"repro_torch.core.workspace",
                   "repro_torch.core.refs"})),
}


class DeprecationRule(Rule):
    id = "deprecation"
    pragma = "legacy-ok"
    doc = ("loads of the deprecated names (resolve_snapshot, snapshot_at, "
           "workspace.resolve_branch) outside their shim modules — "
           "including aliasing, getattr, and import-as forms")

    def _allowed(self, name: str, mod: LintModule) -> bool:
        return mod.module in DEPRECATION_MAP[name][1]

    def _flag(self, mod: LintModule, node: ast.AST, name: str,
              how: str) -> Finding:
        repl = DEPRECATION_MAP[name][0]
        return self.finding(
            mod, node,
            f"deprecated {name!r} reached via {how}",
            f"use {repl}; only the shim modules may keep calling it "
            f"(or justify with `# lint: {self.pragma} <reason>`)")

    def check(self, mod: LintModule, project) -> List[Finding]:
        if mod.tree is None:
            return []
        out: List[Finding] = []
        imported: Set[str] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ImportFrom):
                for alias in node.names:
                    if (alias.name in DEPRECATION_MAP
                            and not self._allowed(alias.name, mod)):
                        out.append(self._flag(
                            mod, node, alias.name,
                            "import" + (f" (aliased as {alias.asname})"
                                        if alias.asname else "")))
                    if alias.name in DEPRECATION_MAP:
                        imported.add(alias.asname or alias.name)
            elif isinstance(node, ast.Attribute):
                if (isinstance(node.ctx, ast.Load)
                        and node.attr in DEPRECATION_MAP
                        and not self._allowed(node.attr, mod)):
                    out.append(self._flag(mod, node, node.attr,
                                          "attribute access"))
            elif isinstance(node, ast.Name):
                if (isinstance(node.ctx, ast.Load)
                        and node.id in DEPRECATION_MAP
                        and node.id in imported
                        and not self._allowed(node.id, mod)):
                    out.append(self._flag(mod, node, node.id, "bare name"))
            elif isinstance(node, ast.Call):
                chain = call_chain(node)
                if chain and chain[-1] == "getattr" and len(node.args) >= 2:
                    attr = const_str(node.args[1])
                    if (attr in DEPRECATION_MAP
                            and not self._allowed(attr, mod)):
                        out.append(self._flag(mod, node, attr,
                                              "getattr with a literal"))
        return out
