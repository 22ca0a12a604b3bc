"""repro_torch.core — the git-for-data engine over immutable columnar
storage with MVCC (MatrixOne §§3-5), on torch tensors.

Public API of the port so far:
    Repo                 — the porcelain facade: every VCS verb, on refs
    execute, execute_script (statements) — the paper-style statement door
    Engine, Txn          — tables, transactions, snapshots, clone/restore,
                           ALTER, replay, gc
    Branch, PullRequest  — branches, pull requests, atomic publish, revert
    Schema, Column, CType
    snapshot_diff, sql_diff, DiffResult
    three_way_merge, two_way_merge, ConflictMode, MergeReport
    compact_table, compact_objects
    create_index, lookup_eq — secondary indices as auxiliary tables
    fsck, FsckReport     — integrity verification and salvage
    FaultPlan, inject, InjectedCrash — deterministic crash injection
    TornFrame, CorruptFrame, StoreVersionError — typed durable-format errors
"""
from .schema import CType, Column, Schema                      # noqa: F401
from .directory import Directory, Snapshot                     # noqa: F401
from .engine import (CommitRecord, CommitStats, Engine,        # noqa: F401
                     GCStats, PKViolation, Txn, TxnConflict)
from .sigs import SigBatch, compute_sigs, resolve_sigs         # noqa: F401
from .diff import (DiffResult, gather_payload, gather_rowsigs,  # noqa: F401
                   snapshot_diff, sql_diff)
from .merge import (ConflictMode, MergeConflictError, MergeReport,  # noqa: F401
                    ThreeWayDiff, plan_merge, three_way_diff,
                    three_way_merge, two_way_merge)
from .compaction import compact_objects, compact_table         # noqa: F401
from .indices import IndexSpec, create_index, drop_index, lookup_eq  # noqa: F401,E501
from .wal import (WAL, CorruptFrame, StoreFormatError,         # noqa: F401
                  StoreVersionError, TornFrame, TornTransaction)
from .faults import (FaultPlan, InjectedCrash, crash_point,    # noqa: F401
                     inject, register, registered)
from .fsck import FsckIssue, FsckReport, fsck                  # noqa: F401
from .refs import (AmbiguousRefError, Ref, RefSyntaxError,     # noqa: F401
                   ResolvedRef, UnknownRefError, as_branch,
                   format_ref, parse_ref, resolve)
from .repo import MODE_ALIASES, Repo, parse_mode               # noqa: F401
from .workspace import (TRUNK, Branch, CheckContext,           # noqa: F401
                        CheckResult, PublishBlocked, PullRequest,
                        RevertConflict)
from .statements import (StatementError, StatementResult,      # noqa: F401
                         execute, execute_script)
