"""Quickstart: the paper's git-for-data operations (the port of
``examples/quickstart.py``).

Runs the paper §3 workflow (Listing 1): snapshot → clone → independent
edits → diff → three-way merge, on a lineitem-like table of 100,000 rows —
then shares the result with a second repo through a bare remote directory
(push → shallow clone → fetch → pull). It prints what the reference's
script prints, line for line.

  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Without ``--device`` it runs on the card, and raises when there is none.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile

import numpy as np

from ..configs.paper_vcs import LINEITEM_SCHEMA, gen_lineitem
from ..core import ConflictMode, Engine, Repo, snapshot_diff, three_way_merge
from ..store import clone
from ..vcs_cli import load_repo

N_ROWS = 100_000


def edited(base, sl, price_bump, tag):
    """Rows ``sl`` of ``base`` repriced by ``price_bump``, with comments
    ``<tag>-<i>`` (values really change)."""
    out = {k: v[sl].copy() for k, v in base.items()}
    out["l_extendedprice"] = out["l_extendedprice"] * price_bump
    out["l_comment"] = np.array(
        [b"%s-%d" % (tag, i) for i in range(len(out["l_comment"]))],
        dtype=object)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    engine = Engine(device=args.device)
    engine.create_table("lineitem", LINEITEM_SCHEMA)
    engine.insert("lineitem", gen_lineitem(N_ROWS))
    print(f"lineitem: {engine.table('lineitem').count():,} rows")

    # CREATE SNAPSHOT sn1 FOR TABLE lineitem        (a git tag)
    sn1 = engine.create_snapshot("sn1", "lineitem")

    # CREATE TABLE t FROM SNAPSHOT lineitem{sn1}    (instant clone)
    engine.clone_table("t", "sn1")
    print(f"clone cost: {engine.table('t').directory.meta_nbytes()} "
          f"metadata bytes (data shared, zero copy)")

    # both branches evolve independently (values actually change!)
    base = gen_lineitem(N_ROWS)
    engine.update_by_keys("lineitem",
                          edited(base, slice(0, 12), 1.10, b"repriced"))
    tx = engine.begin()                       # branch: fix eight comments
    tx.update_by_keys("t", edited(base, slice(40, 48), 1.0, b"fixed"))
    tx.commit()
    sn2 = engine.create_snapshot("sn2", "lineitem")
    sn3 = engine.create_snapshot("sn3", "t")

    # SNAPSHOT DIFF lineitem{sn2} AND t{sn3}
    d = snapshot_diff(engine.store, sn2, sn3)
    print(f"diff: {d.n_groups} differing value-groups; "
          f"scanned {d.stats.rows_scanned:,} rows "
          f"(vs {engine.table('lineitem').count():,} full scan)")

    # SNAPSHOT MERGE TABLE lineitem FROM t{sn3} [BASED ON sn1] ACCEPT
    rep = three_way_merge(engine, "lineitem", sn3, base=sn1,
                          mode=ConflictMode.ACCEPT)
    print(f"merge: {rep.true_conflicts} true / {rep.false_conflicts} false "
          f"conflicts, +{rep.inserted}/-{rep.deleted} rows, "
          f"commit ts {rep.commit_ts}")

    # verify: lineitem now contains t's comment fixes AND its own repricing
    d2 = snapshot_diff(engine.store, engine.current_snapshot("lineitem"),
                       sn3)
    print(f"post-merge diff vs branch: {d2.n_groups} groups "
          f"(= main's own repricing, as expected)")

    # ------------------------------------------------------------ remotes
    # Share the repo through a bare remote directory: refs + WAL +
    # content-addressed pack objects; push/pull move only the objects the
    # other side lacks, and pulled objects carry their signatures — no row
    # is ever re-hashed in transit.
    root = tempfile.mkdtemp(prefix="dg-quickstart-")
    try:
        remote = f"{root}/origin"
        st = Repo(engine).push(remote)        # PUSH TO 'dir'
        print(f"push: {st['objects_pushed']} object(s), "
              f"{st['bytes_pushed']:,} bytes, {st['records_pushed']} WAL "
              f"records")

        # clone --shallow: refs now, objects fault in from origin on first
        # scan
        clone(remote, f"{root}/b.wal", shallow=True)
        other = load_repo(f"{root}/b.wal", args.device)
        print(f"shallow clone: "
              f"{other.engine.table('lineitem').count():,} rows "
              f"visible before any object transfer")
        other.fetch(remote)                   # optional bulk warm-up
        st = other.pull(remote)               # already current -> no-op
        print(f"pull: up_to_date={st['up_to_date']}, "
              f"objects_pulled={st['objects_pulled']}")
        # push is fast-forward-only: divergent histories are refused with
        # a typed RemoteError telling you to pull first
    finally:
        shutil.rmtree(root)


if __name__ == "__main__":
    main()
