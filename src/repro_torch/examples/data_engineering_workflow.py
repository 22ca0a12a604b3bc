"""Collaborative data-engineering workflow (paper §1, §6.3/§6.4) on the
ref-unified porcelain (the port of ``examples/data_engineering_workflow.py``):
one ref grammar, the ``Repo`` facade, and the paper-style statement surface
driving the same verbs.

Two engineers branch the production dataset (100,000 rows), edit in
isolation, open PRs, and CI checks gate what lands. A failing check blocks
one publish until the data is fixed; a conflicting PR is reviewed and
force-resolved; a bad release is rolled back with an inverse-delta revert
— history-preserving, unlike the head-rewriting restore. Every version is
named by a REF (``snap:release-1``, ``pr:2:merged``, ...). It prints what
the reference's script prints, line for line.

  PYTHONPATH=src python -m repro_torch.examples.data_engineering_workflow \\
      --device cpu

Without ``--device`` it runs on the card, and raises when there is none.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..configs.paper_vcs import LINEITEM_SCHEMA, gen_lineitem
from ..core import MergeConflictError, PublishBlocked, Repo, execute
from ..core.statements import execute_script

N_ROWS = 100_000


def edit(base, sl, flag_shift, discount=None):
    """Rows ``sl`` of ``base`` relabelled by ``flag_shift`` (and a flat
    ``discount`` when given), with fresh comments."""
    out = {k: v[sl].copy() for k, v in base.items()}
    out["l_returnflag"] = (out["l_returnflag"] + flag_shift) % 3
    if discount is not None:
        out["l_discount"] = np.full_like(out["l_discount"], discount)
    out["l_comment"] = np.array(
        [b"edit-%d-%d" % (flag_shift, i)
         for i in range(len(out["l_comment"]))], dtype=object)
    return out


def discount_rule(ctx):
    batch, _ = ctx.scan("lineitem")
    return bool((batch["l_discount"] <= 0.1).all())


def row_count_stable(ctx):
    return ctx.count("lineitem") == N_ROWS


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    repo = Repo(device=args.device)
    engine = repo.engine
    repo.create_table("lineitem", LINEITEM_SCHEMA)
    base = gen_lineitem(N_ROWS)
    repo.insert("lineitem", base)
    print(f"prod lineitem: {repo.table('lineitem').count():,} rows")

    # -- branches: isolated metadata-only forks, created by STATEMENT ----
    bytes_before = engine.store.bytes_written
    print(execute(repo, "CREATE BRANCH relabel FOR (lineitem)").message)
    print(execute(repo, "CREATE BRANCH cleanup FOR (lineitem)").message)
    if engine.store.bytes_written != bytes_before:
        raise RuntimeError("creating a branch copied data")
    print(execute(repo, "SHOW BRANCHES").message)

    # -- engineer 1 relabels a shard — but fat-fingers an illegal discount
    repo.update_by_keys("relabel/lineitem",
                        edit(base, slice(0, 2_000), 1, discount=0.75))
    # -- engineer 2 cleans an overlapping shard --------------------------
    repo.update_by_keys("cleanup/lineitem", edit(base, slice(1_000, 3_000),
                                                 2))

    # -- pull requests: pinned-base review diffs + CI checks -------------
    pr1 = repo.open_pr("relabel")            # INTO main (the default)
    pr2 = repo.open_pr("cleanup")
    for pr in (pr1, pr2):
        pr.add_check(discount_rule)
        pr.add_check(row_count_stable)
        # review diff by REF: the PR's pinned base against its head branch
        d = repo.diff(f"pr:{pr.id}:base", f"pr:{pr.id}:head",
                      table="lineitem")
        print(f"PR#{pr.id} {pr.head_name}: {d.n_groups:5d} changed groups, "
              f"rows scanned {d.stats.rows_scanned:,}")

    # -- publish #1: CI catches the bad discount and BLOCKS the publish --
    try:
        repo.publish(pr1.id)
    except PublishBlocked as e:
        print(f"PR#{pr1.id} blocked: {e}")
    # the engineer fixes the branch; the same PR then lands atomically
    repo.update_by_keys("relabel/lineitem", edit(base, slice(0, 2_000), 1))
    rep = repo.publish(pr1.id)["lineitem"]
    print(f"PR#{pr1.id} published: +{rep.inserted}/-{rep.deleted} "
          f"at ts={pr1.publish_ts}")
    print(execute(repo,
                  "CREATE SNAPSHOT release-1 FOR TABLE lineitem").message)

    # -- publish #2 conflicts (overlapping shard): review, then force ----
    dry = pr2.dry_run_merge()["lineitem"]
    print(f"PR#{pr2.id} dry run: {dry.true_conflicts} true conflicts "
          f"(no mutation)")
    try:
        repo.publish(pr2.id)
    except MergeConflictError as e:
        print(f"PR#{pr2.id}: {e.report.true_conflicts} true conflicts under "
              "FAIL -> reviewer ACCEPTs the cleanup branch's version")
    rep = repo.publish(pr2.id, mode="theirs")["lineitem"]   # ACCEPT alias
    print(f"PR#{pr2.id} published: +{rep.inserted}/-{rep.deleted} "
          f"at ts={pr2.publish_ts}")

    # -- oops: release 2 broke the dashboard — revert it -----------------
    ts = repo.revert_pr(pr2.id)
    d = repo.diff("HEAD", "snap:release-1", table="lineitem")
    print(f"reverted PR#{pr2.id} at ts={ts} (Δ-sized, history-preserving): "
          f"{d.n_groups} diff groups vs snap:release-1 (0 = identical)")
    # the reverted release stays reachable through PITR — by REF
    d = repo.diff(f"pr:{pr2.id}:merged", "HEAD", table="lineitem")
    print("published state still visible at its horizon:",
          d.n_groups, "groups differ")

    # -- the commit log names every porcelain op that touched the table --
    print(execute(repo, "LOG TABLE lineitem LIMIT 6").message)

    # -- housekeeping: close the done PRs, drop branches, GC -------------
    repo.close_pr(pr1.id)  # releases the published PR's revert pins
    for res in execute_script(repo,
                              "DROP BRANCH relabel; DROP BRANCH cleanup; GC"):
        print(res.message)


if __name__ == "__main__":
    main()
