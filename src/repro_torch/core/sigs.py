"""Canonical row/key signatures (the paper's §5.5.5 idea, universalized).

Every row gets two 128-bit signatures from the ``rowhash`` kernel:

  * ``row signature`` — over ALL columns: the row's value identity.
  * ``key signature`` — over the PRIMARY KEY columns: the row's logical
    identity. For NoPK tables the key signature IS the row signature (the
    same tensors, aliased).

Each column contributes two uint32 lanes, the canonical 64-bit encoding
of its value; on the device the (R, ncols) int64 word matrix viewed as
int32 IS the (R, 2 * ncols) lane matrix (lo lane first, little-endian).
LOB columns contribute a blake2b 64-bit content signature computed once
on the host at ingest and then moved to the device, so diff/merge never
hold LOB payloads in the aggregation working set.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from .schema import CType, Schema, is_lob

_F64_NAN = 0x7FF8000000000000
_F32_NAN = 0x7FC00000

# When True, every carried ``runs`` claim is verified (per-run key
# monotonicity) before sealing. Off by default: the invariant is held by
# construction. Tests flip it on.
DEBUG_VALIDATE_CARRY = False

_RUN1 = np.zeros((1,), np.int64)
_RUN1.setflags(write=False)


@dataclass
class SigBatch:
    """Signature sidecar carried alongside a row batch into the seal path.

    Lanes are int64 word tensors on the engine's device. ``None`` lanes
    mean "recompute". ``runs`` (host int64 run-start offsets, ``runs[0]
    == 0``) declares that every run ``[runs[i], runs[i+1])`` is sorted by
    (key_lo, key_hi); a single run means the whole batch is key-sorted,
    ``None`` means no ordering is known. Producers must NEVER claim
    sortedness that isn't real."""
    row_lo: Optional[torch.Tensor]
    row_hi: Optional[torch.Tensor]
    key_lo: Optional[torch.Tensor]
    key_hi: Optional[torch.Tensor]
    lob_sigs: Dict[str, torch.Tensor] = field(default_factory=dict)
    runs: Optional[np.ndarray] = None

    @property
    def complete(self) -> bool:
        return self.row_lo is not None and self.key_lo is not None

    @staticmethod
    def sorted_run() -> np.ndarray:
        """The single-run ``runs`` value: "this whole batch is key-sorted"."""
        return _RUN1


def validate_runs(key_lo: torch.Tensor, key_hi: torch.Tensor,
                  runs: np.ndarray) -> None:
    """Raise if any declared run is not (key_lo, key_hi)-monotone."""
    n = key_lo.shape[0]
    if n <= 1:
        return
    lo, hi = ops.flip(key_lo), ops.flip(key_hi)
    bad = (lo[1:] < lo[:-1]) | ((lo[1:] == lo[:-1]) & (hi[1:] < hi[:-1]))
    if bool(bad.any()):
        allowed = torch.zeros((n - 1,), dtype=torch.bool, device=lo.device)
        starts = runs[(runs > 0) & (runs < n)]
        allowed[torch.from_numpy(starts - 1).to(lo.device)] = True
        if bool((bad & ~allowed).any()):
            raise ValueError(
                "SigBatch claims key-sortedness that isn't real: "
                f"{int((bad & ~allowed).sum())} descending pair(s) inside "
                "declared runs")


def concat_sigs(parts: Sequence[SigBatch]) -> SigBatch:
    """Concatenate complete SigBatches, preserving NoPK key==row aliasing
    and the per-part run structure (``None`` anywhere poisons ``runs``)."""
    if len(parts) == 1:
        return parts[0]
    alias = all(p.key_lo is p.row_lo and p.key_hi is p.row_hi for p in parts)
    row_lo = torch.cat([p.row_lo for p in parts])
    row_hi = torch.cat([p.row_hi for p in parts])
    if alias:
        key_lo, key_hi = row_lo, row_hi
    else:
        key_lo = torch.cat([p.key_lo for p in parts])
        key_hi = torch.cat([p.key_hi for p in parts])
    lob = {c: torch.cat([p.lob_sigs[c] for p in parts])
           for c in (parts[0].lob_sigs or {})}
    runs = None
    if all(p.runs is not None for p in parts):
        offs, off = [], 0
        for p in parts:
            offs.append((p.runs if p.runs.shape[0] else _RUN1) + off)
            off += p.row_lo.shape[0]
        runs = np.concatenate(offs)
    # lint: runs-ok concatenation of parts whose own claims carry over
    return SigBatch(row_lo, row_hi, key_lo, key_hi, lob, runs)


def lob_sig64(arr: np.ndarray, device) -> torch.Tensor:
    """Content signature (uint64 bits) per LOB value, hashed on the host
    (one blake2b per row) and moved to ``device``."""
    b2b, ib = hashlib.blake2b, int.from_bytes
    sig = np.fromiter(
        (ib(b2b(v, digest_size=8).digest(), "little") for v in arr),
        np.uint64, count=arr.shape[0])
    return torch.from_numpy(sig.view(np.int64)).to(device)


def _canon64(col, ctype: CType, lob_sig=None) -> torch.Tensor:
    """Canonical 64-bit encoding (int64 bits) of a column's values."""
    if ctype is CType.LOB:
        return lob_sig
    if ctype is CType.I64:
        return col.to(torch.int64)
    if ctype in (CType.I32, CType.BOOL):
        return col.to(torch.int64)
    if ctype is CType.F64:
        w = col.to(torch.float64).contiguous().view(torch.int64)
        w = torch.where(torch.isnan(col), _F64_NAN, w)   # canonical NaN
        return torch.where(col == 0.0, 0, w)             # -0.0 -> +0.0
    if ctype is CType.F32:
        w = col.to(torch.float32).contiguous().view(torch.int32)
        w = w.to(torch.int64) & 0xFFFFFFFF
        w = torch.where(torch.isnan(col), _F32_NAN, w)
        return torch.where(col == 0.0, 0, w)
    raise TypeError(ctype)


def batch_device(batch: Dict[str, object]) -> torch.device:
    """The device of a batch's fixed-width columns (CPU if it has none)."""
    for v in batch.values():
        if not is_lob(v):
            return v.device
    return torch.device("cpu")


def column_lanes(schema: Schema, batch: Dict[str, object],
                 names: Sequence[str],
                 lob_sigs: Dict[str, torch.Tensor] | None = None
                 ) -> torch.Tensor:
    """(R, 2*len(names)) int32 lane matrix (uint32 bits) for the given
    columns, in order: lane 2j is the low half of column j's word, lane
    2j+1 the high half."""
    n = len(batch[names[0]]) if names else 0
    words = [_canon64(batch[name], schema.column(name).ctype,
                      (lob_sigs or {}).get(name)) for name in names]
    if not words:
        return torch.zeros((n, 0), dtype=torch.int32,
                           device=batch_device(batch))
    return torch.stack(words, dim=1).contiguous().view(torch.int32)


def compute_sigs(schema: Schema, batch: Dict[str, object]):
    """Return (row_lo, row_hi, key_lo, key_hi, lob_sigs) for a batch.
    row/key signatures are int64 word tensors from the rowhash kernel."""
    dev = batch_device(batch)
    lob_sigs = {c.name: lob_sig64(batch[c.name], dev)
                for c in schema.columns if c.ctype is CType.LOB}
    row_lanes = column_lanes(schema, batch, schema.names, lob_sigs)
    row_lo, row_hi = ops.signatures_from_lanes(row_lanes)
    if schema.has_pk:
        key_lanes = column_lanes(schema, batch, schema.primary_key, lob_sigs)
        key_lo, key_hi = ops.signatures_from_lanes(key_lanes)
    else:
        # NoPK: identity is the full value (paper §3)
        key_lo, key_hi = row_lo, row_hi
    return row_lo, row_hi, key_lo, key_hi, lob_sigs


def resolve_sigs(schema: Schema, batch: Dict[str, object],
                 sigs: Optional[SigBatch], stats=None) -> SigBatch:
    """Return a complete SigBatch for ``batch``, hashing only what was not
    carried. ``stats`` (an ``engine.CommitStats``) counts the split:
    ``rows_carried`` rode through on write-once signatures,
    ``rows_rehashed`` paid the rowhash kernel, ``lob_rows_hashed`` paid
    per-row blake2b."""
    n = len(batch[schema.names[0]]) if schema.names else 0
    dev = batch_device(batch)
    if sigs is not None:
        # a mismatched sidecar would seal a silently corrupt object
        for name, arr in (("row", sigs.row_lo), ("key", sigs.key_lo),
                          *((f"lob:{c}", a)
                            for c, a in sigs.lob_sigs.items())):
            if arr is not None and arr.shape[0] != n:
                raise ValueError(
                    f"SigBatch {name} lane has {arr.shape[0]} rows, "
                    f"batch has {n}")
        r = sigs.runs
        if r is not None and r.shape[0] and n and (
                r[0] != 0 or (r[1:] <= r[:-1]).any() or r[-1] >= n):
            raise ValueError(
                "SigBatch runs offsets malformed: need runs[0]==0, "
                f"strictly ascending, all < {n} rows")
    if (sigs is not None and sigs.complete
            and all(c.name in sigs.lob_sigs for c in schema.columns
                    if c.ctype is CType.LOB)):
        if stats is not None:
            stats.rows_carried += n
        if not schema.has_pk and sigs.key_lo is not sigs.row_lo:
            # NoPK: key IS the row signature — restore the alias so seal
            # and Δ emission keep recognizing it
            # lint: runs-ok re-wraps the caller's own claim unchanged
            sigs = SigBatch(sigs.row_lo, sigs.row_hi, sigs.row_lo,
                            sigs.row_hi, sigs.lob_sigs, sigs.runs)
        return sigs
    carried_lob = dict(sigs.lob_sigs) if sigs is not None else {}
    lob_sigs = {}
    for c in schema.columns:
        if c.ctype is not CType.LOB:
            continue
        got = carried_lob.get(c.name)
        if got is None:
            got = lob_sig64(batch[c.name], dev)
            if stats is not None:
                stats.lob_rows_hashed += n
        lob_sigs[c.name] = got
    row_lanes = column_lanes(schema, batch, schema.names, lob_sigs)
    row_lo, row_hi = ops.signatures_from_lanes(row_lanes)
    if stats is not None:
        stats.rows_rehashed += n
    if not schema.has_pk:
        key_lo, key_hi = row_lo, row_hi
        # the carried key order (if any) was the OLD row signature order
        runs = None
    elif sigs is not None and sigs.key_lo is not None:
        key_lo, key_hi = sigs.key_lo, sigs.key_hi
        runs = sigs.runs
    else:
        key_lanes = column_lanes(schema, batch, schema.primary_key, lob_sigs)
        key_lo, key_hi = ops.signatures_from_lanes(key_lanes)
        runs = sigs.runs if sigs is not None else None
    # lint: runs-ok the key lanes are the caller's, so is their claim
    return SigBatch(row_lo, row_hi, key_lo, key_hi, lob_sigs, runs)


def key_sigs_for_lookup(schema: Schema, key_batch: Dict[str, object]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Signatures for probe keys given just the PK columns."""
    if not schema.has_pk:
        raise ValueError("key lookups need a primary key")
    lanes = column_lanes(schema, key_batch, schema.primary_key, {})
    return ops.signatures_from_lanes(lanes)
