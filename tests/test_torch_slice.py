"""The port's diff/merge main path against the reference, end to end.

``repro_torch`` on ``device="cpu"`` must reproduce the reference's golden
digests (``GOLDEN`` and ``GOLDEN_APPLY`` in ``tests/test_diff_digest.py``)
byte for byte, and agree side by side with
a live ``repro`` run on identical numpy inputs. Also pinned here: the
slice's boundaries (no JAX and no ``repro`` in the port, no silent CPU
fallback, ``chip_smoke.py`` refusing to run without a card).
"""
import ast
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import ConflictMode as RMode
from repro.core import snapshot_diff as r_snapshot_diff
from repro.core import sql_diff as r_sql_diff
from repro.core import telemetry as r_telemetry
from repro.core import three_way_diff as r_three_way_diff
from repro.core import three_way_merge as r_three_way_merge
from repro_torch.benchmarks import digests, vcs_tables
from repro_torch.core import (ConflictMode, Engine, FaultPlan, InjectedCrash,
                              UnknownRefError, faults, inject, registered,
                              resolve, snapshot_diff, sql_diff, telemetry,
                              three_way_diff, three_way_merge)
from repro_torch.distributed import sharding
from repro_torch.interop import to_numpy
from repro_torch.kernels import build
from test_diff_digest import GOLDEN, GOLDEN_APPLY
from test_diff_digest import run_workload as r_run_workload

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _reset_port_globals():
    build.reset_launches()
    prev = sharding.set_key_shards(None)
    yield
    sharding.set_key_shards(prev)
    faults._ACTIVE = None
    telemetry._ACTIVE = None
    build.reset_launches()


def U(t):
    return to_numpy(t, u64=True)


# ------------------------------------------------------------ golden digests

@pytest.mark.parametrize("pk", [True, False])
def test_port_reproduces_golden_diff_digests(pk):
    got = digests.run_workload(pk, device="cpu")
    assert got == GOLDEN[pk], got
    assert got == r_run_workload(pk)          # a live reference run too


@pytest.mark.parametrize("pk", [True, False])
def test_port_reproduces_golden_merge_digests(pk):
    """Every apply-path golden: the merges, revert, publish and its
    revert."""
    got = digests.run_apply_workload(pk, device="cpu")
    assert got == GOLDEN_APPLY[pk], got


def test_chip_smoke_carries_the_reference_goldens():
    import chip_smoke
    assert chip_smoke.GOLDEN == GOLDEN
    assert chip_smoke.GOLDEN_APPLY == GOLDEN_APPLY


@pytest.mark.parametrize("pk", [True, False])
def test_forced_key_shards_are_byte_identical(pk):
    want = digests.run_workload(pk, n_rows=20_000, csize=1_500, device="cpu")
    sharding.set_key_shards(4)
    got = digests.run_workload(pk, n_rows=20_000, csize=1_500, device="cpu")
    assert got == want


# ----------------------------------------------------------- side by side

def _both(pk, n_rows=6_000, csize=400):
    """The same updates on a reference and a port engine."""
    from benchmarks.vcs_tables import _mk_engine as r_mk
    from benchmarks.vcs_tables import _random_update as r_upd
    out = []
    for mk, upd, kw in ((r_mk, r_upd, {}),
                        (vcs_tables._mk_engine, vcs_tables._random_update,
                         {"device": "cpu"})):
        engine, base = mk(n_rows, pk, **kw)
        sn1 = engine.create_snapshot("sn1", "lineitem")
        engine.clone_table("t", sn1)
        upd(engine, "t", base, csize, np.random.default_rng(7), pk)
        # the target changes too (some keys on both branches)
        upd(engine, "lineitem", base, csize // 2, np.random.default_rng(8),
            pk, tag=1)
        sn3 = engine.create_snapshot("sn3", "t")
        out.append((engine, sn1, sn3))
    return out


def _assert_diff_equal(d_port, d_ref):
    np.testing.assert_array_equal(d_port.diff_cnt.numpy(), d_ref.diff_cnt)
    for f in ("key_lo", "key_hi", "row_lo", "row_hi", "rowid"):
        np.testing.assert_array_equal(U(getattr(d_port, f)),
                                      getattr(d_ref, f))
    assert d_port.stats.rows_scanned == d_ref.stats.rows_scanned


@pytest.mark.parametrize("pk", [True, False])
def test_diff_merge_scan_side_by_side_with_reference(pk):
    (re, r1, r3), (pe, p1, p3) = _both(pk)
    r_cur, p_cur = (re.current_snapshot("lineitem"),
                    pe.current_snapshot("lineitem"))
    _assert_diff_equal(snapshot_diff(pe.store, p_cur, p3),
                       r_snapshot_diff(re.store, r_cur, r3))
    _assert_diff_equal(sql_diff(pe.store, p_cur, p3),
                       r_sql_diff(re.store, r_cur, r3))
    tw = three_way_diff(pe, p1, pe.current_snapshot("lineitem"), p3)
    r_tw = r_three_way_diff(re, r1, re.current_snapshot("lineitem"), r3)
    for f in ("key_lo", "key_hi", "t_rowid", "s_rowid"):
        np.testing.assert_array_equal(U(getattr(tw, f)), getattr(r_tw, f))
    for f in ("status", "t_op", "s_op"):
        np.testing.assert_array_equal(getattr(tw, f).numpy(),
                                      getattr(r_tw, f))
    rehashed = pe.commit_stats.rows_rehashed
    p_rep = three_way_merge(pe, "lineitem", p3, base=p1,
                            mode=ConflictMode.ACCEPT)
    r_rep = r_three_way_merge(re, "lineitem", r3, base=r1, mode=RMode.ACCEPT)
    for f in ("inserted", "deleted", "true_conflicts", "false_conflicts",
              "moves_ignored", "commit_ts"):
        assert getattr(p_rep, f) == getattr(r_rep, f), f
    # the zero-rehash apply: merged rows ride their carried signatures
    assert pe.commit_stats.rows_rehashed == rehashed
    assert pe.commit_stats == pe.commit_stats.__class__(
        **vars(re.commit_stats))
    r_batch, r_rid, r_lo, r_hi = re.table("lineitem").scan(with_sigs=True)
    p_batch, p_rid, p_lo, p_hi = pe.table("lineitem").scan(with_sigs=True)
    for got, want in ((p_rid, r_rid), (p_lo, r_lo), (p_hi, r_hi)):
        np.testing.assert_array_equal(U(got), want)
    for c, v in r_batch.items():
        got = to_numpy(p_batch[c])
        assert list(got) == list(v) if v.dtype == object \
            else got.tobytes() == v.tobytes()
    assert telemetry.metrics_snapshot(pe) == r_telemetry.metrics_snapshot(re)


def test_hotpath_driver_runs_on_cpu():
    out = vcs_tables.diff_merge_hotpath(n_rows=8_000, csizes={"C2": 500},
                                        warm_repeats=2, device="cpu")
    assert [r["op"] for r in out] == ["HotDiffMergePK", "HotDiffMergeNoPK"]
    for r in out:
        assert r["visibility_builds_warm"] == 0
        assert r["merged_inserted"] == r["merged_deleted"] == 500
        assert r["device"] == "cpu"


# --------------------------------------------------------- engine surfaces

def test_engine_device_is_the_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        assert Engine().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine()
    assert Engine(device="cpu").device == torch.device("cpu")


def test_refs_resolve_snapshots_and_refuse_branches():
    """Snapshot, PITR, branch and PR refs resolve; a branch or PR that
    does not exist is refused."""
    engine, _ = vcs_tables._mk_engine(500, True, device="cpu")
    engine.create_snapshot("night", "lineitem")
    assert resolve(engine, "snap:night").table == "lineitem"
    assert resolve(engine, "lineitem@{1}").snapshot.ts == 1
    assert resolve(engine, "night").snapshot is engine.snapshots["night"]
    for ref in ("branch:dev", "pr:1:base"):
        with pytest.raises(UnknownRefError):
            resolve(engine, ref, table="lineitem")
    engine.create_branch("dev", ["lineitem"])
    pr = engine.open_pr("main", "dev")
    assert resolve(engine, "branch:dev", table="lineitem").table == \
        "dev/lineitem"
    assert resolve(engine, "pr:1:base", table="lineitem").snapshot is \
        pr.base_pins["lineitem"]
    for ref in ("branch:qa", "pr:2:base"):
        with pytest.raises(UnknownRefError):
            resolve(engine, ref, table="lineitem")
    with pytest.raises(ValueError):
        engine.create_snapshot("a b", "lineitem")


def test_crash_points_are_the_ports_own_and_abort_whole_commits():
    names = set(registered())
    assert names and all(n.startswith("torch.") for n in names)
    engine, base = vcs_tables._mk_engine(500, True, device="cpu")
    before = (engine.ts, engine.store._next_oid,
              engine.table("lineitem").directory, len(engine.wal))
    batch = {k: v[:10].copy() for k, v in base.items()}
    batch["l_orderkey"] = batch["l_orderkey"] + 10_000
    with pytest.raises(InjectedCrash):
        with inject(FaultPlan.at("torch.engine.commit.pre_seal")):
            engine.insert("lineitem", batch)
    assert (engine.ts, engine.store._next_oid,
            engine.table("lineitem").directory, len(engine.wal)) == before
    with inject(FaultPlan()) as plan:
        engine.insert("lineitem", batch)
    assert plan.hits["torch.wal.append"] == 1
    assert plan.hits["torch.engine.commit.post_seal"] == 1


def test_spans_and_stats_key_set_match_the_reference():
    engine, _ = vcs_tables._mk_engine(800, False, device="cpu")
    with telemetry.trace(engine) as tr:
        sn = engine.create_snapshot("s", "lineitem")
        snapshot_diff(engine.store, sn, engine.current_snapshot("lineitem"))
    assert [s.name for s in tr.roots] == ["diff"]
    assert set(telemetry.stats_json(engine)["metrics"]) == \
        set(r_telemetry.registered_metrics())
    assert telemetry.STATS_SCHEMA == r_telemetry.STATS_SCHEMA


# ------------------------------------------------------------ boundaries

def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_never_imports_jax_or_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro")]
    assert not bad, bad
    code = ("import sys, repro_torch.core, repro_torch.benchmarks.digests, "
            "repro_torch.core.fsck, repro_torch.store, "
            "repro_torch.store.packs, repro_torch.store.remote, "
            "repro_torch.vcs_cli, "
            "repro_torch.interop, repro_torch.kernels.build, "
            "repro_torch.configs, repro_torch.models.lm, "
            "repro_torch.models.convert, repro_torch.launch.serve, "
            "repro_torch.benchmarks.serve_consistency, "
            "repro_torch.optim, repro_torch.data, repro_torch.checkpoint, "
            "repro_torch.launch.train, repro_torch.examples.train_versioned, "
            "repro_torch.kernels.flash_attention_bwd, "
            "repro_torch.launch.mesh, repro_torch.launch.op_analysis, "
            "repro_torch.launch.dryrun; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'ml_dtypes', 'repro')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(REPO / "src"),
                        "PATH": "/usr/bin:/bin"})


def test_chip_smoke_refuses_without_a_card_or_the_sources(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke would run")
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    run = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, env=env,
                         cwd=tmp_path, timeout=120)
    assert run.returncode != 0 and '"ok"' not in run.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone / "chip_smoke.py")
    run = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, env=env,
                         cwd=alone, timeout=120)
    assert run.returncode != 0 and '"ok"' not in run.stdout
