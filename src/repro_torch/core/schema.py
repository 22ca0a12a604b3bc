"""Table schemas and row batches.

A row batch is a ``dict[str, column]``. Fixed-width columns are torch
tensors of the column dtype on the engine's device; LOB columns (TEXT /
JSON / BLOB of the paper §5.5.5) stay host-side numpy object arrays of
``bytes``, as in the reference.

Diff/merge require *schema compatibility* (paper §3): same column names,
types and order, and the same primary-key definition.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class CType(enum.Enum):
    I64 = "i64"
    I32 = "i32"
    F64 = "f64"
    F32 = "f32"
    BOOL = "bool"
    LOB = "lob"  # TEXT / JSON / BLOB — stored in-table, diffed by signature


_NP_DTYPES = {
    CType.I64: np.int64,
    CType.I32: np.int32,
    CType.F64: np.float64,
    CType.F32: np.float32,
    CType.BOOL: np.bool_,
}

_TORCH_DTYPES = {
    CType.I64: torch.int64,
    CType.I32: torch.int32,
    CType.F64: torch.float64,
    CType.F32: torch.float32,
    CType.BOOL: torch.bool,
}

_PK_TYPES = (CType.I64, CType.I32)


@dataclass(frozen=True)
class Column:
    name: str
    ctype: CType


@dataclass(frozen=True)
class Schema:
    columns: Tuple[Column, ...]
    primary_key: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names: {names}")
        if self.primary_key:
            by_name = {c.name: c for c in self.columns}
            for k in self.primary_key:
                if k not in by_name:
                    raise ValueError(f"primary key column {k!r} not in schema")
                if by_name[k].ctype not in _PK_TYPES:
                    raise ValueError(
                        f"primary key column {k!r} must be integer-typed")

    # -- helpers ---------------------------------------------------------
    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(c.name for c in self.columns)

    @property
    def has_pk(self) -> bool:
        return bool(self.primary_key)

    def column(self, name: str) -> Column:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)

    def np_dtype(self, name: str):
        ct = self.column(name).ctype
        return np.object_ if ct is CType.LOB else _NP_DTYPES[ct]

    def compatible_with(self, other: "Schema") -> bool:
        """Diff/merge compatibility (paper §3)."""
        return (self.names == other.names
                and tuple(c.ctype for c in self.columns)
                == tuple(c.ctype for c in other.columns)
                and self.primary_key == other.primary_key)

    # -- batch utilities --------------------------------------------------
    def validate_batch(self, batch: Dict[str, object]) -> int:
        if set(batch.keys()) != set(self.names):
            raise ValueError(
                f"batch columns {sorted(batch)} != schema {sorted(self.names)}")
        n = -1
        for c in self.columns:
            rows = len(batch[c.name])
            if n < 0:
                n = rows
            elif rows != n:
                raise ValueError("ragged batch")
        return n

    def normalize_batch(self, batch: Dict[str, Sequence],
                        device) -> Dict[str, object]:
        """Columns as the engine stores them: LOB as a host object array
        of bytes, every other column as a tensor of the column dtype on
        ``device`` (numpy input keeps its memory on the CPU)."""
        out = {}
        for c in self.columns:
            vals = batch[c.name]
            if c.ctype is CType.LOB:
                arr = np.empty((len(vals),), dtype=object)
                for i, v in enumerate(vals):
                    if isinstance(v, str):
                        v = v.encode()
                    if not isinstance(v, (bytes, bytearray)):
                        raise TypeError(f"LOB column {c.name}: want bytes/str")
                    arr[i] = bytes(v)
                out[c.name] = arr
            elif torch.is_tensor(vals):
                out[c.name] = vals.to(device=device,
                                      dtype=_TORCH_DTYPES[c.ctype])
            else:
                a = np.ascontiguousarray(vals, dtype=_NP_DTYPES[c.ctype])
                out[c.name] = torch.from_numpy(a).to(device)
        self.validate_batch(out)
        return out


def is_lob(col) -> bool:
    """True for a host LOB column (numpy object array)."""
    return isinstance(col, np.ndarray)


def batch_nbytes(schema: Schema, batch: Dict[str, object]) -> int:
    """Logical payload bytes of a batch (for the paper's Table-1 space cost)."""
    total = 0
    for c in schema.columns:
        arr = batch[c.name]
        if c.ctype is CType.LOB:
            total += int(sum(map(len, arr.tolist())))
        else:
            total += arr.numel() * arr.element_size()
    return total


def concat_batches(schema: Schema, batches: Sequence[Dict[str, object]],
                   device) -> Dict[str, object]:
    if not batches:
        return {c.name: (np.zeros((0,), dtype=object)
                         if c.ctype is CType.LOB else
                         torch.zeros((0,), dtype=_TORCH_DTYPES[c.ctype],
                                     device=device))
                for c in schema.columns}
    out = {}
    for c in schema.columns:
        parts = [b[c.name] for b in batches]
        out[c.name] = (np.concatenate(parts) if c.ctype is CType.LOB
                       else torch.cat(parts))
    return out


def take_batch(batch: Dict[str, object], idx) -> Dict[str, object]:
    """Rows ``idx`` (an int64 index tensor) of every column: device
    indexing for tensors, one host copy of the index for LOB columns."""
    host = None
    out = {}
    for k, v in batch.items():
        if is_lob(v):
            if host is None:
                host = idx.cpu().numpy() if torch.is_tensor(idx) else idx
            out[k] = v[host]
        else:
            out[k] = v[idx]
    return out
