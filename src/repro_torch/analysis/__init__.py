"""Static invariant analysis of the port's own package.

The port's copy of ``repro.analysis``, keyed to ``repro_torch.*``: the
producer and hot-path module sets, the WAL, engine and telemetry modules,
the deprecation shims and the core's clock rule name the port's modules,
and the rules know the port's torch idiom (``torch.sort``, in-place tensor
methods, torch's RNG). ``python -m repro_torch.analysis [paths...]`` lints
``src/repro_torch``; ``datagit lint`` (``python -m repro_torch.vcs_cli
lint``) and the ``LINT`` statement are doors onto the same runner. See
:mod:`repro_torch.analysis.runner` for the pass list, the pragma grammar
and the pinned JSON schema.
"""
from .base import Finding, LintModule, Rule
from .runner import (ALL_RULES, KNOWN_TOKENS, SCHEMA_VERSION, default_paths,
                     discover_count, load_baseline, main, render_text,
                     repo_root, run_analysis, to_json)

__all__ = [
    "ALL_RULES", "Finding", "KNOWN_TOKENS", "LintModule", "Rule",
    "SCHEMA_VERSION", "default_paths", "discover_count", "load_baseline",
    "main", "render_text", "repo_root", "run_analysis", "to_json",
]
