"""Metadata directories and snapshots (paper §4).

A *directory* is the immutable metadata structure listing every object of a
table plus the MVCC visibility horizon. **A snapshot is just a frozen
directory** — which is why clone (copy the directory) and restore (repoint
the table at a directory) are O(metadata), the paper's headline property.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from .schema import Schema


@dataclass(frozen=True)
class Directory:
    data_oids: Tuple[int, ...]      # sorted
    tomb_oids: Tuple[int, ...]      # sorted
    ts: int                         # visibility horizon (commit ts <= ts)

    @staticmethod
    def empty(ts: int = 0) -> "Directory":
        return Directory((), (), ts)

    def with_objects(self, new_data=(), new_tombs=(), *, ts: int) -> "Directory":
        return Directory(tuple(sorted(set(self.data_oids) | set(new_data))),
                         tuple(sorted(set(self.tomb_oids) | set(new_tombs))),
                         ts)

    def replace(self, drop_data=(), drop_tombs=(), add_data=(), add_tombs=(),
                *, ts: Optional[int] = None) -> "Directory":
        return Directory(
            tuple(sorted((set(self.data_oids) - set(drop_data)) | set(add_data))),
            tuple(sorted((set(self.tomb_oids) - set(drop_tombs)) | set(add_tombs))),
            self.ts if ts is None else ts,
        )

    def meta_nbytes(self) -> int:
        """Metadata size — what clone actually copies (Table 1 'Space')."""
        return 16 * (len(self.data_oids) + len(self.tomb_oids)) + 8


@dataclass(frozen=True)
class Snapshot:
    """A named (git tag) or timestamp (git commit) snapshot of one table."""
    name: Optional[str]             # None for anonymous/timestamp snapshots
    table: str
    schema: Schema
    directory: Directory
    created_ts: int

    @property
    def ts(self) -> int:
        return self.directory.ts
