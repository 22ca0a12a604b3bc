"""The paper's diff/merge workload on the port (§6 tables).

A TPC-H-lineitem-like table with change sets C1..C4 = 100/1k/10k/100k
updated rows. Only the pieces the tests and ``chip_smoke.py`` drive are
here: the engine builder, the random update, and the cold/warm
diff + merge hot path.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from ..configs.paper_vcs import (LINEITEM_SCHEMA, LINEITEM_SCHEMA_NOPK,
                                 gen_lineitem)
from ..core import (ConflictMode, Engine, snapshot_diff, three_way_merge)
from ..core import telemetry

CHANGE_SETS = {"C1": 100, "C2": 1_000, "C3": 10_000, "C4": 100_000}


def _visibility_builds(engine: Engine) -> int:
    cache = engine.store.vis_cache
    return int(cache.builds) if cache is not None else 0


def _sync(engine: Engine) -> None:
    """Wait for the device, so a host clock read after it times the work
    and not only its enqueue."""
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def diff_merge_hotpath(n_rows: int = 2_000_000, csizes=None,
                       warm_repeats: int = 3, device=None) -> List[Dict]:
    """Cold vs warm repeated diff + merge per change set.

    The warm timings measure what the visibility and delta caches buy:
    repeated SNAPSHOT DIFF between the same two directory versions must
    not rebuild the sorted tombstone-target arrays. Times are host-clock
    seconds around work that ends in a device synchronize."""
    out = []
    for pk in (True, False):
        for cname, csize in (csizes or CHANGE_SETS).items():
            csize = min(csize, n_rows // 5)
            rng = np.random.default_rng([csize] + list(cname.encode()))
            engine, base = _mk_engine(n_rows, pk, device=device)
            sn1 = engine.create_snapshot("sn1", "lineitem")
            engine.clone_table("t", sn1)
            _random_update(engine, "t", base, csize, rng, pk)
            sn3 = engine.create_snapshot("sn3", "t")
            cur = engine.current_snapshot("lineitem")
            _sync(engine)

            b0 = _visibility_builds(engine)
            t0 = time.perf_counter()
            d_cold = snapshot_diff(engine.store, cur, sn3)
            _sync(engine)
            t_cold = time.perf_counter() - t0
            builds_cold = _visibility_builds(engine) - b0

            warm_times = []
            b1 = _visibility_builds(engine)
            for _ in range(warm_repeats):
                t0 = time.perf_counter()
                d_warm = snapshot_diff(engine.store, cur, sn3)
                _sync(engine)
                warm_times.append(time.perf_counter() - t0)
            builds_warm = _visibility_builds(engine) - b1
            assert d_warm.n_groups == d_cold.n_groups == 2 * csize

            b2 = _visibility_builds(engine)
            t0 = time.perf_counter()
            rep = three_way_merge(engine, "lineitem", sn3, base=sn1,
                                  mode=ConflictMode.ACCEPT)
            _sync(engine)
            t_merge = time.perf_counter() - t0
            builds_merge = _visibility_builds(engine) - b2

            out.append({
                "op": f"HotDiffMerge{'PK' if pk else 'NoPK'}",
                "change": cname, "rows": n_rows, "changed_rows": csize,
                "device": str(engine.device),
                "diff_cold_s": t_cold,
                "diff_warm_s": float(np.min(warm_times)),
                "diff_warm_avg_s": float(np.mean(warm_times)),
                "merge_s": t_merge,
                "visibility_builds_cold": builds_cold,
                "visibility_builds_warm": builds_warm,
                "visibility_builds_merge": builds_merge,
                "rows_scanned_diff": d_cold.stats.rows_scanned,
                "objects_scanned_diff": d_cold.stats.objects_scanned,
                "merged_inserted": rep.inserted,
                "merged_deleted": rep.deleted,
                "counters": telemetry.metrics_snapshot(engine),
            })
    return out


def _mk_engine(n_rows: int, pk: bool, seed: int = 0, device=None):
    engine = Engine(device=device)
    schema = LINEITEM_SCHEMA if pk else LINEITEM_SCHEMA_NOPK
    engine.create_table("lineitem", schema)
    base = gen_lineitem(n_rows, seed=seed)
    engine.insert("lineitem", base)
    return engine, base


def _random_update(engine: Engine, table: str, base, n: int, rng,
                   pk: bool, tag: int = 0):
    """Update n random rows (by PK when available; by rowid for NoPK).
    ``base`` is the numpy batch the table was loaded from."""
    idx = rng.choice(base["l_orderkey"].shape[0], size=n, replace=False)
    newvals = {k: v[idx].copy() for k, v in base.items()}
    newvals["l_quantity"] = newvals["l_quantity"] + 1.0 + tag
    newvals["l_comment"] = np.array(
        [b"upd-%d-%d" % (tag, i) for i in range(n)], dtype=object)
    tx = engine.begin()
    if pk:
        tx.update_by_keys(table, newvals)
    else:
        t = engine.table(table)
        _, rowids = t.scan()
        tx.delete_rowids(table, rowids[torch.from_numpy(idx).to(
            rowids.device)])
        tx.insert(table, newvals)
    tx.commit()
    return idx
