"""Write-ahead log (the LogService/TN roles of paper §4), in memory.

Every logical state change appends a record. This slice of the port keeps
the log in memory: records hold the committed batches as the engine
staged them (tensors included). Replay and the framed durable store come
with a later slice; anything serialized then goes out as numpy.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

from .faults import crash_point, register

# Every record kind the engine of this slice emits.
KINDS = frozenset({
    # storage / transaction layer
    "create_table", "drop_table", "commit", "snapshot", "drop_snapshot",
    "clone", "restore", "set_base",
    # workflow porcelain: branches, pull requests, atomic publish, Δ-revert
    "create_branch", "drop_branch", "open_pr", "close_pr", "publish",
    "publish_revert", "revert",
})

CP_TORCH_WAL_APPEND = register(
    "torch.wal.append",
    "before a record is appended to the in-memory WAL — the Nth hit kills "
    "the process at the Nth record boundary")


@dataclass
class WalRecord:
    kind: str                 # one of KINDS
    payload: Dict[str, Any] = field(default_factory=dict)


class WAL:
    def __init__(self):
        self.records: List[WalRecord] = []
        # telemetry counters (wal.frames / wal.bytes / wal.fsyncs); the
        # in-memory log writes no bytes and syncs nothing
        self.frames = 0
        self.bytes_written = 0
        self.fsyncs = 0

    def append(self, kind: str, **payload) -> None:
        # hard error, not assert: a typo'd kind would only explode later
        if kind not in KINDS:
            raise ValueError(f"unknown WAL record kind {kind!r}")
        # the crash fires BEFORE the record exists
        crash_point(CP_TORCH_WAL_APPEND)
        self.records.append(WalRecord(kind, payload))
        self.frames += 1

    def __iter__(self):
        return iter(self.records)

    def __len__(self):
        return len(self.records)
