"""End-to-end training on versioned data with fault-tolerant checkpoints
(the port of ``examples/train_versioned.py``).

The full production loop on a reduced model:
  1. ingest a corpus into a versioned table, pin a snapshot, train; a
     fault is injected mid-run, and the trainer detects the NaN state and
     rolls back to the last versioned checkpoint (an instant metadata
     restore);
  2. a data engineer curates extra samples on a branch (a clone of the
     pinned corpus), reviews the diff and merges it into the corpus;
  3. training continues on a new pin of the enriched corpus, while the
     first run's pinned snapshot is untouched (isolation).

  PYTHONPATH=src python -m repro_torch.examples.train_versioned --device cpu

Without ``--device`` it runs on the card.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core import ConflictMode, Engine, snapshot_diff, three_way_merge
from ..data import add_samples
from ..launch.train import train_loop


def curate(engine: Engine, n_new: int = 64, sample_len: int = 65,
           vocab: int = 512, seed: int = 1, first_id: int = 1000):
    """Phase 2: clone the first pin of the corpus to ``corpus_dev``, add
    ``n_new`` samples there (ids from ``first_id``), snapshot it as
    ``curated``, review the diff against the corpus and merge it in
    (ACCEPT). Returns (the review diff's group count, the merge
    report)."""
    pin = [s for s in engine.snapshots if s.startswith("train-pin")][0]
    engine.clone_table("corpus_dev", engine.snapshots[pin])
    rng = np.random.default_rng(seed)
    new_ids = np.arange(first_id, first_id + n_new)
    add_samples(engine, "corpus_dev", new_ids,
                [rng.integers(2, vocab, size=sample_len).astype(np.uint32)
                 for _ in new_ids])
    dev_snap = engine.create_snapshot("curated", "corpus_dev")
    d = snapshot_diff(engine.store, engine.current_snapshot("corpus"),
                      dev_snap)
    rep = three_way_merge(engine, "corpus", dev_snap,
                          mode=ConflictMode.ACCEPT)
    return d.n_groups, rep


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    # --- phase 1: train with an injected fault (rollback demo) ---------
    _, losses, engine = train_loop(
        "qwen1.5-0.5b", steps=40, seq_len=64, global_batch=8,
        ckpt_every=10, inject_fault_at=25, log_every=10, device=args.device)
    print(f"phase 1: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({len(losses)} healthy steps, incl. rollback recovery)")

    # --- phase 2: curate more data on a branch and merge it ------------
    n_diff, rep = curate(engine)
    print(f"phase 2: review diff = {n_diff} new/changed samples")
    print(f"phase 2: merged {rep.inserted} curated samples into corpus "
          f"(atomic publish, ts={rep.commit_ts})")

    # --- phase 3: continue training on the enriched corpus -------------
    _, losses2, _ = train_loop(
        "qwen1.5-0.5b", steps=20, seq_len=64, global_batch=8,
        ckpt_every=10, engine=engine, log_every=10, device=args.device)
    print(f"phase 3: loss {losses2[0]:.3f} -> {losses2[-1]:.3f} on merged "
          f"data")
    print("done: versioned data + versioned checkpoints, one engine.")


if __name__ == "__main__":
    main()
