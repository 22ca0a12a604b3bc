"""Lint framework core: findings, pragma grammar, module model, rule base.

The port's own copy of ``repro.analysis.base``. The analysis suite
machine-checks the engine's invariants: sortedness/carry claims,
crash-point coverage, the deprecation map, WAL/replay hygiene, and
sealed-object immutability. Everything is pure-``ast`` — no imports of
the linted code, so a module that fails to import (no CUDA device, no
``torch``) still lints.

Pragma grammar
--------------
A finding is suppressed by a *justified* pragma on the finding line or on a
comment-only line directly above it::

    # lint: <token> <reason>
    arr = SignedStream(..., runs=my_runs)          # suppressed (if justified)

    tx.insert(t, batch, sigs=sigs)  # lint: runs-ok gathered from sealed objs

``<token>`` names the rule being silenced (each rule owns one token — see
``Rule.pragma``). ``<reason>`` is REQUIRED: a bare ``# lint: runs-ok``
does not suppress and itself raises a ``pragma`` finding, so suppressions
stay reviewable. Unknown tokens are flagged too (catches typos that would
otherwise silently fail to suppress).
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

#: the pragma marker (hash, "lint:", token, reason) anywhere in a line —
#: trailing comments and comment-only lines both match
PRAGMA_RE = re.compile(r"#\s*lint:\s*([A-Za-z0-9_-]+)[ \t]*(.*?)\s*$")

#: line is nothing but a comment (a *standalone* pragma line applies to the
#: first code line below it)
COMMENT_ONLY_RE = re.compile(r"^\s*#")


@dataclass(frozen=True)
class Finding:
    """One rule violation, pinned to a source location."""
    rule: str                  # rule id, e.g. "sorted-claims"
    path: str                  # repo-relative posix path
    line: int                  # 1-based
    col: int                   # 0-based
    message: str               # what is wrong
    hint: str = ""             # how to fix (or how to suppress with a reason)
    suppressed: bool = False   # a justified pragma covers this finding
    reason: str = ""           # the pragma's justification text

    def key(self) -> Tuple[str, str, str]:
        """Identity for baseline diffing: line numbers drift across edits,
        (rule, path, message) survives them."""
        return (self.rule, self.path, self.message)

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message, "hint": self.hint,
                "suppressed": self.suppressed, "reason": self.reason}

    def render(self) -> str:
        tag = f" [suppressed: {self.reason}]" if self.suppressed else ""
        out = f"{self.path}:{self.line}:{self.col}: {self.rule}: " \
              f"{self.message}{tag}"
        if self.hint and not self.suppressed:
            out += f"\n    hint: {self.hint}"
        return out


class LintModule:
    """One parsed source file: AST + raw lines + pragma table."""

    def __init__(self, path: Path, root: Path):
        self.path = path
        self.rel = path.relative_to(root).as_posix()
        self.module = self._module_name(self.rel)
        self.source = path.read_text()
        self.lines = self.source.splitlines()
        #: 1-based line -> [(token, reason)]
        self.pragmas: Dict[int, List[Tuple[str, str]]] = {}
        self.parse_error: Optional[Finding] = None
        try:
            self.tree: Optional[ast.AST] = ast.parse(self.source,
                                                     filename=str(path))
        except SyntaxError as err:
            self.tree = None
            self.parse_error = Finding(
                rule="parse", path=self.rel, line=err.lineno or 1,
                col=err.offset or 0,
                message=f"syntax error: {err.msg}",
                hint="the analysis suite requires every scanned file to "
                     "parse")
        self._scan_pragmas()

    @staticmethod
    def _module_name(rel: str) -> str:
        parts = rel.split("/")
        # the package path below the last src/ directory, so that a tree
        # linted from inside the checkout (build/<tree>/src/...) keeps the
        # module names its keyed rules look for
        srcs = [i for i, d in enumerate(parts[:-1]) if d == "src"]
        if srcs:
            parts = parts[srcs[-1] + 1:]
        if parts[-1] == "__init__.py":
            parts = parts[:-1]
        elif parts[-1].endswith(".py"):
            parts[-1] = parts[-1][:-3]
        return ".".join(parts)

    def _scan_pragmas(self) -> None:
        for i, line in enumerate(self.lines, start=1):
            m = PRAGMA_RE.search(line)
            if m:
                token, reason = m.group(1), m.group(2).strip()
                self.pragmas.setdefault(i, []).append((token, reason))

    def pragma_reason(self, line: int, token: str) -> Optional[str]:
        """The justification suppressing ``token`` at ``line`` (or None).

        Looks at the finding line itself, then at a run of comment-only
        lines directly above (so a pragma can sit above a long wrapped
        statement)."""
        for tok, reason in self.pragmas.get(line, ()):
            if tok == token and reason:
                return reason
        j = line - 1
        while j >= 1 and COMMENT_ONLY_RE.match(self.lines[j - 1] or ""):
            for tok, reason in self.pragmas.get(j, ()):
                if tok == token and reason:
                    return reason
            j -= 1
        return None


class Rule:
    """Base class: one invariant pass. Subclasses set ``id`` (finding tag),
    ``pragma`` (suppression token) and ``doc``, and implement ``check``."""

    id: str = ""
    pragma: str = ""
    doc: str = ""

    def check(self, mod: LintModule, project) -> List[Finding]:
        raise NotImplementedError

    def finding(self, mod: LintModule, node: ast.AST, message: str,
                hint: str = "") -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        if not hint:
            hint = (f"justify with `# lint: {self.pragma} <reason>` "
                    "if this is intentional")
        return Finding(rule=self.id, path=mod.rel, line=line, col=col,
                       message=message, hint=hint)


# --------------------------------------------------------------------------
# small AST helpers shared by the rules
# --------------------------------------------------------------------------

def attr_chain(node: ast.AST) -> List[str]:
    """``np.random.default_rng`` -> ['np', 'random', 'default_rng'];
    [] when the expression is not a pure Name/Attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []


def call_chain(node: ast.Call) -> List[str]:
    return attr_chain(node.func)


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def is_none(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Constant) and node.value is None


def keyword_arg(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None
