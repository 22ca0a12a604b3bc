"""The port's VCS examples against the reference's scripts.

``examples/quickstart.py`` and ``examples/data_engineering_workflow.py``
run through the JAX package (``JAX_PLATFORMS=cpu``), and
``repro_torch.examples.quickstart`` and ``.data_engineering_workflow``
with ``--device cpu``, each in a process of its own, started together:
their standard output must be equal byte for byte (row counts, groups,
conflicts, logical timestamps, push bytes, the log and GC's counts).
Without ``--device`` the port's examples want the card and raise where
there is none. ``chip_smoke.examples_phase`` drives the same comparison
between the CPU and the card.
"""
import os
import subprocess
import sys

import pytest
import torch

import chip_smoke

REPO = chip_smoke.ROOT


def _start(argv):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    return subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)


@pytest.mark.parametrize("name", chip_smoke.EXAMPLES)
def test_port_example_prints_what_the_reference_prints(name):
    ref = _start([sys.executable, str(REPO / "examples" / f"{name}.py")])
    port = _start([sys.executable, "-m", f"repro_torch.examples.{name}",
                   "--device", "cpu"])
    out = {}
    for side, proc in (("ref", ref), ("port", port)):
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr.decode()[-2000:]
        out[side] = stdout
    assert out["port"] == out["ref"]
    assert out["port"].count(b"\n") == {"quickstart": 8,
                                        "data_engineering_workflow": 24}[name]


@pytest.mark.parametrize("name", chip_smoke.EXAMPLES)
def test_port_example_wants_the_card_without_device(name, monkeypatch):
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def test_chip_smoke_examples_phase_runs_on_the_cpu():
    rec = chip_smoke.examples_phase(device="cpu")
    assert set(rec) == set(chip_smoke.EXAMPLES)
    for name, r in rec.items():
        assert r["stdout_equal"] and r["main_s"] > 0
        assert not any(r["launches"].values())  # the CPU launches nothing


def test_chip_smoke_lint_phase_runs_on_the_cpu(tmp_path):
    rec = chip_smoke.lint_phase(device="cpu", root=tmp_path / "planted")
    assert rec["findings"] == 0 and rec["planted"]["exit"] == 1
    assert [r for _, r in rec["planted"]["flagged"]] == \
        ["wal-hygiene", "hidden-sort", "sealed-write"]
    assert rec["suppressed"] == sum(rec["suppressed_by_rule"].values())
