"""The port's invariant lint (``repro_torch.analysis``) side by side with
the reference's (``repro.analysis``).

Every test of ``tests/test_analysis.py`` runs here once more with its
linting doors wrapped: each fixture tree the reference test lints is
mirrored for the port (``src/repro/...`` as ``src/repro_torch/...``,
``repro.`` as ``repro_torch.`` in the sources) and linted by the port's
runner, whose findings must equal the reference's in rule, path, line,
column, suppression, reason, message and hint up to the package prefix;
``main`` (the ``python -m`` door) must give the reference's exit code and
text. Where a reference test drives a door that has no wrapper (the
rule list, the committed baseline, a subprocess, the CLI, the ``LINT``
statement, the whole tree) the port's door is checked beside it.

Then the port's torch idiom: ``torch.sort``, in-place tensor methods,
``torch.inference_mode()`` and torch's RNG are flagged by the port's
lint (and not by the reference's, which does not know them), and each
numpy counterpart by both. The port's own tree lints clean under its own
lint, and its three doors share one runner.
"""
import contextlib
import inspect
import io
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

import repro.analysis as RA
import repro_torch.analysis as PA
import repro_torch.analysis.runner as PA_runner
import test_analysis as T

REPO = PA.repo_root()

#: the fixture tests of tests/test_analysis.py, each one counted case here
REFERENCE_TESTS = (
    "test_sorted_claims_positive_and_negative",
    "test_sorted_claims_allowlists_producer_modules",
    "test_hidden_sort_positive_and_negative",
    "test_crash_coverage_positive_and_negative",
    "test_deprecation_catches_aliasing_attr_and_getattr",
    "test_wal_hygiene_positive_and_negative",
    "test_wal_hygiene_clock_allowlist",
    "test_sealed_write_positive_negative_and_taint",
    "test_pragma_meta_rule",
    "test_repo_lints_clean",
    "test_every_rule_has_distinct_pragma_token",
    "test_json_schema_pinned",
    "test_committed_baseline_matches_schema_and_is_clean",
    "test_baseline_diff_lets_known_findings_through",
    "test_ci_gate_fails_on_injected_bad_snippet",
    "test_datagit_lint_shares_the_runner",
    "test_lint_statement_surface",
)


# ------------------------------------------------------------ mirroring

def port_path(ref: Path) -> Path:
    """Where the port's mirror of the reference fixture tree ``ref``
    lives: a sibling directory."""
    return ref.with_name(ref.name + "-port")


def mirror(ref: Path) -> Path:
    """Copy every ``.py`` file of ``ref`` to its port mirror, with
    ``src/repro/`` as ``src/repro_torch/`` and ``repro.`` as
    ``repro_torch.`` (files of other kinds, such as a baseline the port
    writes itself, are left alone)."""
    dst = port_path(ref)
    for f in sorted(ref.rglob("*.py")):
        rel = f.relative_to(ref).as_posix()
        if rel.startswith("src/repro/"):
            rel = "src/repro_torch/" + rel[len("src/repro/"):]
        g = dst / rel
        g.parent.mkdir(parents=True, exist_ok=True)
        g.write_text(re.sub(r"\brepro\.", "repro_torch.", f.read_text()))
    return dst


def unport(text: str) -> str:
    return text.replace("repro_torch", "repro")


def ref_key(f):
    return (f.rule, f.path, f.line, f.col, f.message, f.hint, f.suppressed,
            f.reason)


def port_key(f):
    return (f.rule, unport(f.path), f.line, f.col, unport(f.message),
            unport(f.hint), f.suppressed, unport(f.reason))


def twin_run_analysis(paths, root=None, rules=None):
    """The reference's ``run_analysis``, with the port's runner over the
    mirrored tree held equal to it; returns the reference's findings."""
    found = RA.run_analysis(paths, root=root, rules=rules)
    if root is not None and Path(root) == REPO:
        return found                    # the whole tree: see the extras
    assert rules is None
    port = PA.run_analysis([mirror(Path(p)) for p in paths],
                           root=port_path(Path(root)))
    assert [port_key(f) for f in port] == [ref_key(f) for f in found]
    return found


def twin_lint_main(argv):
    """The reference's ``main``, with the port's ``main`` over the
    mirrored tree giving the same exit code and text; the reference's
    text goes on to the caller's stdout."""
    tree = Path(argv[0])
    ref_out, port_out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(ref_out):
        rc = RA.main(argv)
    dst = mirror(tree)
    port_argv = [str(dst / Path(a).relative_to(tree))
                 if a.startswith(str(tree)) else a for a in argv]
    with contextlib.redirect_stdout(port_out):
        port_rc = PA.main(port_argv)
    assert port_rc == rc
    assert unport(port_out.getvalue().replace(str(dst), str(tree))) == \
        ref_out.getvalue()
    print(ref_out.getvalue(), end="")
    return rc


# ---------------------------------------------- the doors without a wrapper

def _port_tree_lints_clean(tmp_path, capsys):
    findings = PA.run_analysis(PA.default_paths(REPO), root=REPO)
    bad = [f for f in findings if not f.suppressed]
    assert not bad, "\n".join(f.render() for f in bad)
    assert all(f.reason for f in findings if f.suppressed)


def _same_rules(tmp_path, capsys):
    assert [(r.id, r.pragma) for r in PA.ALL_RULES] == \
        [(r.id, r.pragma) for r in RA.ALL_RULES]
    assert PA.KNOWN_TOKENS == RA.KNOWN_TOKENS


def _same_json(tmp_path, capsys):
    tree = tmp_path / "json"
    bad = tree / "src" / "repro" / "core" / "merge.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import numpy as np\nx = np.unique(y)\n")
    ref = RA.to_json(RA.run_analysis([tree], root=tree), nfiles=1)
    port = PA.to_json(PA.run_analysis([mirror(tree)], root=port_path(tree)),
                      nfiles=1)
    assert port["rules"] == ref["rules"]
    assert json.loads(unport(json.dumps(port))) == ref


def _same_baseline_reader(tmp_path, capsys):
    base = REPO / "LINT_baseline.json"
    assert PA.load_baseline(base) == RA.load_baseline(base) == set()


def _port_module_door_exits_1(tmp_path, capsys):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis",
         str(port_path(tmp_path))],
        capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 1, proc.stderr
    assert "hidden-sort" in proc.stdout


def _port_cli_door(tmp_path, capsys):
    from repro.vcs_cli import main as ref_cli
    from repro_torch.vcs_cli import main as port_cli
    capsys.readouterr()
    assert ref_cli(["lint", str(tmp_path), "--format", "json"]) == 1
    ref_doc = json.loads(capsys.readouterr().out)
    assert port_cli(["lint", str(mirror(tmp_path)), "--format", "json"]) == 1
    port_doc = json.loads(capsys.readouterr().out)
    assert json.loads(unport(json.dumps(port_doc))) == ref_doc
    assert port_cli(["lint"]) == 0


def _port_lint_statement(tmp_path, capsys):
    from repro_torch.core import Repo
    from repro_torch.core.statements import execute
    res = execute(Repo(device="cpu"), "LINT")
    assert res.kind == "lint"
    assert "0 finding(s)" in res.message


#: the port's door beside each reference test that drives one the
#: wrappers do not reach
EXTRAS = {
    "test_repo_lints_clean": _port_tree_lints_clean,
    "test_every_rule_has_distinct_pragma_token": _same_rules,
    "test_json_schema_pinned": _same_json,
    "test_committed_baseline_matches_schema_and_is_clean":
        _same_baseline_reader,
    "test_ci_gate_fails_on_injected_bad_snippet": _port_module_door_exits_1,
    "test_datagit_lint_shares_the_runner": _port_cli_door,
    "test_lint_statement_surface": _port_lint_statement,
}


@pytest.mark.parametrize("name", REFERENCE_TESTS)
def test_reference_lint_case_holds_for_the_port(name, tmp_path, capsys,
                                                monkeypatch):
    monkeypatch.setattr(T, "run_analysis", twin_run_analysis)
    monkeypatch.setattr(T, "lint_main", twin_lint_main)
    fn = getattr(T, name)
    fixtures = {"tmp_path": tmp_path, "capsys": capsys}
    fn(**{p: fixtures[p] for p in inspect.signature(fn).parameters})
    if name in EXTRAS:
        EXTRAS[name](tmp_path, capsys)


def test_every_reference_lint_test_has_its_twin():
    names = sorted(n for n, f in vars(T).items()
                   if n.startswith("test_") and callable(f))
    assert names == sorted(REFERENCE_TESTS)


# ------------------------------------------------------ the torch idiom

def lint_both(tmp_path, name, files):
    """Write ``files`` ({relpath under the package: source}) as
    ``src/repro/<rel>`` and ``src/repro_torch/<rel>`` and lint each with
    its package: (reference findings, port findings), unsuppressed."""
    found = {}
    for side, pkg, api in (("ref", "repro", RA), ("port", "repro_torch", PA)):
        base = tmp_path / f"{name}-{side}"
        for rel, src in files.items():
            f = base / "src" / pkg / rel
            f.parent.mkdir(parents=True, exist_ok=True)
            f.write_text(src.replace("PKG.", pkg + "."))
        found[side] = [f for f in api.run_analysis([base], root=base)
                       if not f.suppressed]
    return found["ref"], found["port"]


def rules_at(findings):
    return sorted((f.rule, f.path.split("/", 2)[2], f.line)
                  for f in findings)


WAL_FACTS = {
    "core/wal.py": "KINDS = frozenset({'commit'})\n",
    "core/engine.py": (
        "class Engine:\n"
        "    @staticmethod\n"
        "    def replay(wal):\n"
        "        for rec in wal:\n"
        "            if rec.kind == 'commit':\n"
        "                pass\n"),
}

#: rule -> (files in the torch idiom, [(rule, rel, line)] the port flags
#: there; the numpy counterpart, [(rule, rel, line)] both flag there;
#: torch code that stays clean)
TORCH_TWINS = {
    "hidden-sort": (
        {"core/merge.py": ("import torch\n"
                           "o = torch.sort(hi).indices\n"
                           "u = torch.unique(x)\n"
                           "a = torch.argsort(lo, stable=True)\n")},
        [("hidden-sort", "core/merge.py", 2),
         ("hidden-sort", "core/merge.py", 3),
         ("hidden-sort", "core/merge.py", 4)],
        {"core/merge.py": ("import numpy as np\n"
                           "o = np.lexsort((hi, lo))\n"
                           "u = numpy.unique(x)\n")},
        [("hidden-sort", "core/merge.py", 2),
         ("hidden-sort", "core/merge.py", 3)],
        {"core/fsck.py": "import torch\nu = torch.unique(x)\n",
         "core/merge.py": ("import torch\n"
                           "# lint: sort-ok fixture — a reasoned sort\n"
                           "o = torch.sort(hi)\n")}),
    "sealed-write": (
        {"app.py": ("import torch\n"
                    "def direct(obj):\n"
                    "    obj.key_lo.add_(1)\n"
                    "def viewed(obj):\n"
                    "    obj.row_lo.view(-1).narrow(0, 0, 4).zero_()\n"
                    "def aliased(obj, x):\n"
                    "    lane = obj.cols['v'].flatten()\n"
                    "    lane.copy_(x)\n"
                    "def rearmed(obj):\n"
                    "    with torch.inference_mode():\n"
                    "        obj.commit_ts.fill_(0)\n")},
        [("sealed-write", "app.py", 3), ("sealed-write", "app.py", 5),
         ("sealed-write", "app.py", 8), ("sealed-write", "app.py", 10),
         ("sealed-write", "app.py", 11)],
        {"app.py": ("def numpy_lane(obj):\n"
                    "    obj.key_lo.fill(0)\n"
                    "    flat = obj.cols['v'].ravel()\n"
                    "    flat[3] = 1\n"
                    "    obj.target.setflags(write=True)\n")},
        [("sealed-write", "app.py", 2), ("sealed-write", "app.py", 4),
         ("sealed-write", "app.py", 5)],
        {"app.py": ("import torch\n"
                    "def fresh(obj):\n"
                    "    lane = obj.cols['v'].clone()\n"
                    "    lane.add_(1)\n"
                    "    both = torch.cat([obj.key_lo, obj.key_hi])\n"
                    "    both.zero_()\n"
                    "    (obj.row_lo + 1).mul_(2)\n"
                    "    with torch.inference_mode(False):\n"
                    "        pass\n")}),
    "wal-hygiene": (
        {**WAL_FACTS, "app.py": (
            "import torch\n"
            "def log_draw(self):\n"
            "    self.wal.append('commit', seed=torch.randint(0, 9, (1,)))\n"
            "def log_generator(self):\n"
            "    g = torch.Generator()\n"
            "    self.wal.append('commit', g=g)\n"
            "def log_reseed(self):\n"
            "    torch.cuda.manual_seed(1)\n"
            "    self.wal.append('commit')\n")},
        [("wal-hygiene", "app.py", 3), ("wal-hygiene", "app.py", 5),
         ("wal-hygiene", "app.py", 8)],
        {**WAL_FACTS, "app.py": (
            "import numpy as np\n"
            "def log_draw(self):\n"
            "    self.wal.append('commit', seed=np.random.default_rng())\n"),
         "core/clocky.py": ("import time\n"
                            "t = time.perf_counter()\n")},
        [("wal-hygiene", "app.py", 3), ("wal-hygiene", "core/clocky.py", 2)],
        {**WAL_FACTS, "app.py": (
            "import torch\n"
            "def log_seeded(self, s):\n"
            "    g = torch.Generator().manual_seed(s)\n"
            "    self.wal.append('commit', g=g, x=torch.empty(3))\n"),
         "core/telemetry.py": "import time\nt = time.perf_counter()\n"}),
}


@pytest.mark.parametrize("rule", sorted(TORCH_TWINS))
def test_torch_idiom_is_flagged_by_the_port_alone(rule, tmp_path):
    torch_files, torch_flags, np_files, np_flags, clean = TORCH_TWINS[rule]
    ref, port = lint_both(tmp_path, "torch", torch_files)
    assert rules_at(port) == torch_flags
    assert not [f for f in ref if f.rule == rule]
    ref, port = lint_both(tmp_path, "numpy", np_files)
    assert rules_at(ref) == rules_at(port) == np_flags
    ref, port = lint_both(tmp_path, "clean", clean)
    assert not [f for f in port if f.rule == rule]


def test_hidden_sort_names_the_call_as_written(tmp_path):
    _, port = lint_both(tmp_path, "t", TORCH_TWINS["hidden-sort"][0])
    assert [f.message.split(" in ")[0] for f in port] == \
        ["torch.sort", "torch.unique", "torch.argsort"]


# ------------------------------------------------------- the port's tree

def test_port_lint_scans_the_port_package_only():
    assert PA.default_paths(REPO) == [REPO / "src" / "repro_torch"]
    files = PA.discover_count(PA.default_paths(REPO))
    assert files == len(list((REPO / "src" / "repro_torch").rglob("*.py")))


def test_the_reference_lint_keyed_to_the_port_flags_the_reference():
    """Why the port's lint scans only the port: its keys name the port's
    modules, so the reference's tree, whose producers are not reviewed
    under those keys, is full of findings."""
    found = PA.run_analysis([REPO / "src" / "repro"], root=REPO)
    assert {f.rule for f in found if not f.suppressed} >= {"sorted-claims"}


def test_every_port_suppression_is_reasoned_and_counted():
    findings = PA.run_analysis(PA.default_paths(REPO), root=REPO)
    assert not [f for f in findings if not f.suppressed]
    by_rule = {}
    for f in findings:
        assert f.reason, f.render()
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    # the reference's reasons at its own sorts, the freeze's inference
    # mode, and the suppressions the port carried before its lint
    assert by_rule == {"hidden-sort": 8, "sealed-write": 2,
                       "crash-coverage": 2, "deprecation": 2}


def test_fsck_reads_no_clock():
    fs = PA.run_analysis([REPO / "src" / "repro_torch" / "core"], root=REPO)
    assert not [f for f in fs if f.rule == "wal-hygiene"]
    assert "perf_counter" not in (REPO / "src" / "repro_torch" / "core" /
                                  "fsck.py").read_text()


def test_three_doors_share_one_runner(tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.analysis``, ``datagit lint`` and ``LINT``
    each run the one ``run_analysis`` over the same paths and print the
    same text; the module door, run as a process, exits 0 with the same
    JSON."""
    from repro_torch.core import Repo
    from repro_torch.core.statements import execute
    from repro_torch.vcs_cli import main as cli_main
    calls = []
    real = PA_runner.run_analysis

    def counted(paths, root=None, rules=None):
        calls.append((list(paths), root))
        return real(paths, root=root, rules=rules)

    monkeypatch.setattr(PA_runner, "run_analysis", counted)
    monkeypatch.setattr(PA, "run_analysis", counted)
    assert PA.main([]) == 0
    module_text = capsys.readouterr().out
    assert cli_main(["lint"]) == 0
    assert capsys.readouterr().out == module_text
    res = execute(Repo(device="cpu"), "LINT")
    assert res.message + "\n" == module_text
    want = (PA.default_paths(REPO), REPO)
    assert calls == [want] * 3
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--format", "json"],
        capture_output=True, text=True, cwd=tmp_path,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    findings = real(*want)
    assert json.loads(proc.stdout) == PA.to_json(
        findings, PA.discover_count(want[0]))


def test_module_names_come_from_below_the_last_src_directory(tmp_path):
    """A tree linted from inside the checkout (as ``chip_smoke.py``'s
    planted tree under ``build/`` is) keeps the module names its keyed
    rules look for."""
    bad = tmp_path / "build" / "planted" / "src" / "repro_torch" / "core"
    bad.mkdir(parents=True)
    (bad / "merge.py").write_text("import torch\no = torch.sort(x)\n")
    (bad / "clocky.py").write_text("import time\nt = time.time()\n")
    found = PA.run_analysis([tmp_path / "build"], root=tmp_path)
    assert sorted((f.rule, f.path) for f in found) == [
        ("hidden-sort", "build/planted/src/repro_torch/core/merge.py"),
        ("wal-hygiene", "build/planted/src/repro_torch/core/clocky.py")]
    assert "repro_torch.core.merge" in found[0].message + found[1].message
