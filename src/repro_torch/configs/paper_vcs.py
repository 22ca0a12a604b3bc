"""paper_vcs — the paper's own workload: a TPC-H-lineitem-like versioned
table. Generation is seeded numpy, identical to the reference package's,
so both packages see the same rows; the engine moves the fixed-width
columns to its device at insert."""
from __future__ import annotations

import numpy as np

from ..core.schema import Column, CType, Schema

LINEITEM_SCHEMA = Schema(
    columns=(
        Column("l_orderkey", CType.I64),
        Column("l_linenumber", CType.I32),
        Column("l_partkey", CType.I64),
        Column("l_suppkey", CType.I64),
        Column("l_quantity", CType.F64),
        Column("l_extendedprice", CType.F64),
        Column("l_discount", CType.F64),
        Column("l_tax", CType.F64),
        Column("l_returnflag", CType.I32),
        Column("l_linestatus", CType.I32),
        Column("l_shipdate", CType.I64),
        Column("l_comment", CType.LOB),
    ),
    primary_key=("l_orderkey", "l_linenumber"),
)

LINEITEM_SCHEMA_NOPK = Schema(LINEITEM_SCHEMA.columns, primary_key=None)


def gen_lineitem(n: int, seed: int = 0, comments: bool = True):
    """Synthetic lineitem rows (clustered by (orderkey, linenumber) like the
    paper's load order)."""
    rng = np.random.default_rng(seed)
    orderkey = np.repeat(np.arange(n // 4 + 1, dtype=np.int64), 4)[:n]
    linenumber = (np.arange(n, dtype=np.int64) % 4 + 1).astype(np.int32)
    batch = {
        "l_orderkey": orderkey,
        "l_linenumber": linenumber,
        "l_partkey": rng.integers(1, 200_000, n).astype(np.int64),
        "l_suppkey": rng.integers(1, 10_000, n).astype(np.int64),
        "l_quantity": rng.integers(1, 50, n).astype(np.float64),
        "l_extendedprice": np.round(rng.uniform(900, 105_000, n), 2),
        "l_discount": np.round(rng.uniform(0, 0.1, n), 2),
        "l_tax": np.round(rng.uniform(0, 0.08, n), 2),
        "l_returnflag": rng.integers(0, 3, n).astype(np.int32),
        "l_linestatus": rng.integers(0, 2, n).astype(np.int32),
        "l_shipdate": rng.integers(8000, 11000, n).astype(np.int64),
    }
    if comments:
        tags = rng.integers(0, 1 << 30, n)
        batch["l_comment"] = np.array(
            [b"comment-%d" % t for t in tags], dtype=object)
    else:
        batch["l_comment"] = np.array([b""] * n, dtype=object)
    return batch
