"""Secondary indices as auxiliary versioned tables (paper §5.5.4).

A secondary index is an auxiliary table of the indexed columns' signature
and the base table's primary-key columns. Index maintenance rides inside
the SAME transaction as the base-table change (atomic), and
``clone_table(..., with_indices=True)`` clones the auxiliary tables
(metadata-only, like any clone).

The auxiliary schema is (isig I64, <pk columns>) with primary key
(isig, pk...): ``isig`` is the 64-bit signature of the indexed column
values (the low word of the rowhash kernel's signature over their lanes),
so an equality lookup is one device mask over one integer column.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch

from ..kernels import ops
from .schema import Column, CType, Schema
from .sigs import batch_device, column_lanes, lob_sig64


@dataclass(frozen=True)
class IndexSpec:
    name: str
    table: str
    columns: Tuple[str, ...]   # indexed columns of the base table

    @property
    def aux_table(self) -> str:
        return f"__idx_{self.table}_{self.name}"


def _isig(schema: Schema, batch, columns) -> torch.Tensor:
    """Signature of the indexed column values (the int64 bits of the
    uint64 signature's low word)."""
    dev = batch_device(batch)
    lob_sigs = {c: lob_sig64(batch[c], dev) for c in columns
                if schema.column(c).ctype is CType.LOB}
    lanes = column_lanes(schema, batch, columns, lob_sigs)
    lo, _ = ops.signatures_from_lanes(lanes)
    return lo


def aux_schema(base: Schema) -> Schema:
    assert base.has_pk, "secondary indices require a primary key"
    cols = (Column("isig", CType.I64),) + tuple(
        base.column(c) for c in base.primary_key)
    return Schema(cols, primary_key=("isig",) + tuple(base.primary_key))


def backfill_index(engine, spec: IndexSpec, batch=None):
    """Create ``spec``'s aux table and backfill it from the base table.

    The single backfill implementation — used by CREATE INDEX and by
    snapshot-clone index rebuilds (sub-operations unlogged either way).
    ``batch`` lets a caller rebuilding several indices share one base-table
    scan; returns the batch actually used so it can be reused."""
    t = engine.table(spec.table)
    engine.create_table(spec.aux_table, aux_schema(t.schema), _log=False)
    if batch is None:
        batch, _ = t.scan()
    if batch[t.schema.primary_key[0]].shape[0]:
        tx = engine.begin()
        tx.insert(spec.aux_table, aux_rows(t.schema, spec, batch))
        engine._commit(tx, _log=False)
    return batch


def create_index(engine, table: str, name: str, columns: Sequence[str],
                 *, _log: bool = True) -> IndexSpec:
    """CREATE INDEX name ON table(columns) — backfills existing rows.

    The WAL carries ONE create_index record; replay re-runs the aux-table
    creation and backfill deterministically (sub-operations unlogged)."""
    t = engine.table(table)
    spec = IndexSpec(name, table, tuple(columns))
    for c in columns:
        t.schema.column(c)  # validates
    if _log:
        engine.wal.append("create_index", table=table, name=name,
                          columns=tuple(columns))
    engine.indices.setdefault(table, []).append(spec)
    backfill_index(engine, spec)
    return spec


def drop_index(engine, table: str, name: str, *, _log: bool = True) -> None:
    specs = engine.indices.get(table, [])
    spec = next(s for s in specs if s.name == name)
    specs.remove(spec)
    engine.drop_table(spec.aux_table, _log=False)
    if _log:
        engine.wal.append("drop_index", table=table, name=name)


def aux_rows(schema: Schema, spec: IndexSpec, batch) -> Dict[str, object]:
    out = {"isig": _isig(schema, batch, spec.columns)}
    for c in schema.primary_key:
        out[c] = batch[c]
    return out


def lookup_eq(engine, table: str, name: str,
              values) -> Dict[str, torch.Tensor]:
    """Equality lookup: returns the base-table PK columns of matching rows
    (tensors on the engine's device).

    ``values``: dict {indexed column -> scalar or array of length 1}."""
    t = engine.table(table)
    spec = next(s for s in engine.indices.get(table, [])
                if s.name == name)
    sub = Schema(tuple(t.schema.column(c) for c in spec.columns))
    probe = {}
    for c in spec.columns:
        v = values[c]
        if torch.is_tensor(v):
            probe[c] = v.reshape(-1)[:1]
        elif isinstance(v, (bytes, bytearray, str)) or not hasattr(
                v, "__len__"):
            probe[c] = [v]
        else:
            probe[c] = v
    probe = sub.normalize_batch(probe, engine.device)
    sig = _isig(sub, probe, spec.columns)[0]
    aux = engine.table(spec.aux_table)
    batch, _ = aux.scan()
    hit = batch["isig"] == sig
    return {c: batch[c][hit] for c in t.schema.primary_key}


def maintain_on_commit(engine, tx, table: str,
                       ins_batches, del_rowids: torch.Tensor) -> None:
    """Expand a txn with the auxiliary-table changes (same-commit atomic)."""
    from .diff import gather_payload
    t = engine.table(table)
    for spec in engine.indices.get(table, []):
        if del_rowids.shape[0]:
            dead = gather_payload(engine.store, t.schema, del_rowids)
            keys = aux_rows(t.schema, spec, dead)
            tx.delete_by_keys(spec.aux_table, keys)
        for b in ins_batches:
            tx.insert(spec.aux_table, aux_rows(t.schema, spec, b))
