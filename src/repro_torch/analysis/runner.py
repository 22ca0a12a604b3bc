"""Run the analysis suite over a tree and render/diff the findings.

The port's copy of ``repro.analysis.runner``: the same JSON schema, exit
codes, baseline diffing and text rendering, over the port's own package
(``src/repro_torch``, where its benchmarks and examples live too).

``python -m repro_torch.analysis``, ``datagit lint`` and the ``LINT``
statement all land here. Exit
code contract (shell-gateable, like ``dg pr check``): 0 = no unsuppressed
findings, 1 = findings, 2 = usage/parse failure.

JSON schema (pinned; ``LINT_baseline.json`` is a committed snapshot)::

    {
      "schema": 1,
      "rules": {"<rule id>": "<pragma token>", ...},
      "counts": {"files": N, "findings": N, "suppressed": N},
      "findings": [
        {"rule": ..., "path": ..., "line": N, "col": N,
         "message": ..., "hint": ..., "suppressed": bool, "reason": ...},
        ...
      ]
    }

Baseline diffing keys findings on (rule, path, message) — line numbers
drift across unrelated edits and must not churn the baseline. With
``--baseline``, only findings NOT in the snapshot fail the run, so a new
rule can land with its legacy findings recorded and be burned down
finding-by-finding instead of blocking mid-migration.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional, Sequence

from .base import Finding, LintModule, Rule
from .project import Project
from .rules_claims import HiddenSortRule, SortedClaimsRule
from .rules_crash import CrashCoverageRule
from .rules_deprecation import DeprecationRule
from .rules_sealed import SealedWriteRule
from .rules_wal import WalHygieneRule

SCHEMA_VERSION = 1

ALL_RULES: List[Rule] = [
    SortedClaimsRule(), HiddenSortRule(), CrashCoverageRule(),
    DeprecationRule(), WalHygieneRule(), SealedWriteRule(),
]

#: tokens a pragma may name: every rule's token (the "pragma" meta-rule
#: rejects the rest as typos)
KNOWN_TOKENS = frozenset(r.pragma for r in ALL_RULES)

#: directories scanned by default, relative to the repo root: the port's
#: own package (the reference's lint keeps ``src/repro`` and the reference's
#: ``benchmarks/`` and ``examples/``)
DEFAULT_SUBDIRS = ("src/repro_torch",)


def repo_root() -> Path:
    """The checkout root, located from this installed package
    (``<root>/src/repro_torch/analysis/runner.py``)."""
    return Path(__file__).resolve().parents[3]


def discover(paths: Sequence[Path]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        if p.is_file() and p.suffix == ".py":
            files.append(p)
        elif p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
    return files


def default_paths(root: Path) -> List[Path]:
    return [root / d for d in DEFAULT_SUBDIRS if (root / d).is_dir()]


def discover_count(paths: Sequence[Path]) -> int:
    return len(discover(paths))


def _pragma_findings(mod: LintModule) -> List[Finding]:
    """The meta-rule: every pragma must name a known token and carry a
    reason. Unsuppressible by design — a suppression that needs
    suppressing is a review problem, not a lint problem."""
    out: List[Finding] = []
    for line, entries in sorted(mod.pragmas.items()):
        for token, reason in entries:
            if token not in KNOWN_TOKENS:
                out.append(Finding(
                    rule="pragma", path=mod.rel, line=line, col=0,
                    message=f"unknown lint pragma token {token!r}",
                    hint=f"known tokens: {', '.join(sorted(KNOWN_TOKENS))}"))
            elif not reason:
                out.append(Finding(
                    rule="pragma", path=mod.rel, line=line, col=0,
                    message=f"pragma '# lint: {token}' has no reason — "
                            "it does not suppress anything",
                    hint="suppressions must say WHY: "
                         f"`# lint: {token} <reason>`"))
    return out


def run_analysis(paths: Sequence[Path], root: Optional[Path] = None,
                 rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    """Lint ``paths`` (files or directories); returns ALL findings,
    suppressed ones included (callers filter on ``.suppressed``)."""
    root = root or repo_root()
    rules = list(rules if rules is not None else ALL_RULES)
    modules = [LintModule(f, root) for f in discover(paths)]
    project = Project(modules)
    findings: List[Finding] = []
    for mod in modules:
        if mod.parse_error is not None:
            findings.append(mod.parse_error)
            continue
        findings.extend(_pragma_findings(mod))
        for rule in rules:
            for f in rule.check(mod, project):
                reason = mod.pragma_reason(f.line, rule.pragma)
                if reason is not None:
                    f = Finding(rule=f.rule, path=f.path, line=f.line,
                                col=f.col, message=f.message, hint=f.hint,
                                suppressed=True, reason=reason)
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def to_json(findings: Sequence[Finding], nfiles: int) -> dict:
    unsup = [f for f in findings if not f.suppressed]
    return {
        "schema": SCHEMA_VERSION,
        "rules": {r.id: r.pragma for r in ALL_RULES},
        "counts": {"files": nfiles, "findings": len(unsup),
                   "suppressed": len(findings) - len(unsup)},
        "findings": [f.to_json() for f in findings],
    }


def load_baseline(path: Path) -> set:
    data = json.loads(path.read_text())
    if data.get("schema") != SCHEMA_VERSION:
        raise ValueError(
            f"baseline {path} has schema {data.get('schema')!r}, this "
            f"tool writes schema {SCHEMA_VERSION} — regenerate with "
            "--write-baseline")
    return {(f["rule"], f["path"], f["message"])
            for f in data["findings"] if not f.get("suppressed")}


def render_text(findings: Sequence[Finding], nfiles: int,
                verbose: bool = False) -> str:
    unsup = [f for f in findings if not f.suppressed]
    lines = [f.render() for f in unsup]
    if verbose:
        lines += [f.render() for f in findings if f.suppressed]
    nsup = len(findings) - len(unsup)
    lines.append(f"{nfiles} file(s) checked: {len(unsup)} finding(s), "
                 f"{nsup} suppressed")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis",
        description="invariant lint for the VCS engine: sortedness/carry "
                    "claims, crash-point coverage, deprecations, "
                    "WAL/replay hygiene, sealed-object immutability")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the repo's "
                         "src/repro_torch/)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--baseline", metavar="FILE", default=None,
                    help="only findings absent from this snapshot fail "
                         "the run")
    ap.add_argument("--write-baseline", metavar="FILE", default=None,
                    help="write the JSON snapshot and exit 0")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also list suppressed findings")
    args = ap.parse_args(argv)

    root = repo_root()
    paths = ([Path(p).resolve() for p in args.paths] if args.paths
             else default_paths(root))
    for p in paths:
        if not p.exists():
            print(f"error: no such path {p}", file=sys.stderr)
            return 2
    try:
        for p in paths:
            p.relative_to(root)
    except ValueError:
        # linting out-of-tree paths (tests do this with fixture dirs):
        # rebase "repo-relative" onto their common parent
        import os
        root = Path(os.path.commonpath(
            [str(p if p.is_dir() else p.parent) for p in paths]))
    nfiles = len(discover(paths))
    try:
        findings = run_analysis(paths, root=root)
    except OSError as err:
        print(f"error: {err}", file=sys.stderr)
        return 2

    if args.write_baseline:
        Path(args.write_baseline).write_text(
            json.dumps(to_json(findings, nfiles), indent=2,
                       sort_keys=True) + "\n")
        print(f"baseline written to {args.write_baseline}")
        return 0

    failing = [f for f in findings if not f.suppressed]
    if args.baseline:
        try:
            known = load_baseline(Path(args.baseline))
        except (OSError, ValueError, KeyError) as err:
            print(f"error: cannot load baseline: {err}", file=sys.stderr)
            return 2
        failing = [f for f in failing if f.key() not in known]

    if args.format == "json":
        print(json.dumps(to_json(findings, nfiles), indent=2,
                         sort_keys=True))
    else:
        print(render_text(findings, nfiles, verbose=args.verbose))
        if args.baseline and not failing:
            nbase = sum(1 for f in findings
                        if not f.suppressed) - len(failing)
            if nbase:
                print(f"({nbase} known finding(s) covered by baseline "
                      f"{args.baseline})")
    return 1 if failing else 0
