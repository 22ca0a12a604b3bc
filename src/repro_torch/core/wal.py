"""Write-ahead log (the LogService/TN roles of paper §4, single-node form).

Every logical state change appends a record; ``Engine.replay`` re-executes
the log against a fresh engine and must reproduce identical logical table
contents. Object ids are allocated deterministically, so replay also
reproduces physical layout.

Live records hold the committed batches as the engine staged them
(tensors included). Serialized WALs and the CLI's append-only store share
one framed byte format, and every record goes out as numpy
(``interop.host_tree``), never as a tensor; replay moves the batches onto
the replaying engine's device::

    header   := MAGIC "DGWS" | version u8 | reserved u8*3      (8 bytes)
    frame    := length u32le | crc32c(payload) u32le | payload
    payload  := pickle of a list[WalRecord]

A flipped bit raises :class:`CorruptFrame` naming the frame, a crash-torn
tail raises :class:`TornFrame` carrying the last clean offset
(recoverable — the bytes were never acknowledged), and a store written by
a different format version raises :class:`StoreVersionError` with an
upgrade hint. Headerless legacy stores (a raw pickle stream) still load
via a one-shot legacy path keyed off the pickle protocol-2 opcode.
"""
from __future__ import annotations

import pickle
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Sequence, Tuple

from ..interop import host_tree
from .faults import crash_point, register

# Every record kind the engine may emit and ``Engine.replay`` understands.
# The workflow porcelain logs ONE record per logical operation — its
# sub-operations (clones, merges, the publish commit) are unlogged and
# re-derived deterministically at replay time.
KINDS = frozenset({
    # storage / transaction layer
    "create_table", "drop_table", "commit", "snapshot", "drop_snapshot",
    "clone", "restore", "set_base", "create_index", "drop_index",
    "alter_add_column", "compact",
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


# --------------------------------------------------------------------------
# durable frame format
# --------------------------------------------------------------------------

MAGIC = b"DGWS"
STORE_VERSION = 1
STORE_HEADER = MAGIC + bytes([STORE_VERSION]) + b"\x00\x00\x00"
_FRAME_HEAD = struct.Struct("<II")        # payload length, crc32c(payload)
FRAME_OVERHEAD = _FRAME_HEAD.size


class StoreFormatError(Exception):
    """Base of the typed durable-format errors."""


class TornFrame(StoreFormatError):
    """A frame extends past end-of-file: the torn tail of a crashed append.

    Recoverable by construction — appends are fsynced frame-at-a-time, so
    bytes past ``clean_end`` were never acknowledged to any caller.
    ``tail`` holds them so recovery can preserve, never silently drop."""

    def __init__(self, clean_end: int, tail: bytes):
        super().__init__(
            f"torn frame: {len(tail)} trailing byte(s) past the last clean "
            f"frame at offset {clean_end} (unacknowledged crashed write)")
        self.clean_end = clean_end
        self.tail = tail


class CorruptFrame(StoreFormatError):
    """A fully-present frame failed its CRC: mid-file storage corruption.

    NOT auto-recoverable (the frame was acknowledged once): a plain load
    refuses."""

    def __init__(self, frame_index: int, offset: int, why: str):
        super().__init__(
            f"corrupt frame #{frame_index} at offset {offset}: {why}")
        self.frame_index = frame_index
        self.offset = offset


class TornTransaction(StoreFormatError):
    """A multi-table commit group is incomplete in the MIDDLE of the log.

    A trailing incomplete group is normal crash recovery (replay drops it
    whole). Records *after* an incomplete group mean the log itself is
    damaged — replay refuses to guess."""

    def __init__(self, ts: int, have: int, want: int):
        super().__init__(
            f"commit group at ts={ts} has {have} of {want} table records "
            "with later records following — WAL is damaged mid-log")
        self.ts = ts


class StoreVersionError(StoreFormatError):
    """The store's magic/version does not match this build's format."""

    def __init__(self, why: str):
        super().__init__(
            f"{why} — this build reads DGWS v{STORE_VERSION} stores and "
            "legacy headerless pickle stores; re-create the store with "
            "this build (or load it with the build that wrote it)")


#: cumulative bytes hashed without google-crc32c, and the threshold past
#: which a one-shot warning fires (the numpy path is ~10x slower than
#: google-crc32c, the byte loop ~100x). Module globals so tests can shrink
#: the threshold.
_py_crc32c_bytes = 0
_PY_CRC32C_WARN_BYTES = 64 << 20
_py_crc32c_warned = False


def _note_py_crc32c(nbytes: int) -> None:
    """Account fallback-hashed bytes; warn once past the threshold."""
    global _py_crc32c_bytes, _py_crc32c_warned
    _py_crc32c_bytes += nbytes
    if (not _py_crc32c_warned
            and _py_crc32c_bytes > _PY_CRC32C_WARN_BYTES):
        _py_crc32c_warned = True
        import sys
        print(f"datagit: warning: hashed "
              f"{_py_crc32c_bytes / (1 << 20):.0f}MB with the "
              "numpy-sliced crc32c fallback; install google-crc32c "
              "for ~10x faster integrity checks", file=sys.stderr)


_POLY = 0x82F63B78                          # Castagnoli, reflected
_CRC32C_TABLE: List[int] = []


def _crc32c_build_table() -> None:
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        _CRC32C_TABLE.append(c)


def _crc32c_bytes(reg: int, data) -> int:
    """Feed ``data`` through the CRC register one byte at a time."""
    if not _CRC32C_TABLE:
        _crc32c_build_table()
    tab = _CRC32C_TABLE
    for b in bytes(data):
        reg = tab[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg


def _py_crc32c(data: bytes) -> int:
    """CRC32C by the byte table: the reference's fallback."""
    _note_py_crc32c(len(data))
    return _crc32c_bytes(0xFFFFFFFF, data) ^ 0xFFFFFFFF


# -- chunked numpy CRC32C ----------------------------------------------------
#
# CRC without pre/post conditioning ("raw", register 0 at the start) is
# linear over GF(2): raw(A || B) = Z_|B|(raw(A)) ^ raw(B), where Z_n is the
# register map of n zero bytes (a 32x32 bit matrix), and leading zero
# bytes leave raw unchanged. So a block of L-byte lanes is hashed in
# lockstep — one slicing-by-8 step (four 16-bit tables) per 8 bytes over
# every lane at once — and the lanes are folded pairwise in a tree with
# Z_L, Z_2L, ... Blocks are hashed on a small thread pool (numpy's take
# and ufuncs release the GIL), and the register runs across them as
# reg = Z_|b|(reg) ^ raw(b), from 0xFFFFFFFF; the result is reg ^
# 0xFFFFFFFF: bit for bit the value google-crc32c gives.

_NP_LANE = 128              # bytes per lane (16 slicing-by-8 steps)
_NP_BLOCK = 4 << 20         # bytes per block (32Ki lanes), one per task
_NP_MIN = 2048              # below this the byte loop is as fast
_NP_TABLES: List = []       # the four 16-bit slicing tables (uint32)
_NP_POOL: List = []         # the block hashers (a ThreadPoolExecutor)


def _zeros_op(n: int) -> Tuple[int, ...]:
    """Columns of Z_n, the register map of ``n`` zero bytes."""
    op = _ZEROS.get(n)
    if op is None:
        res, sq, k = tuple(1 << i for i in range(32)), _ZEROS[1], n
        while k:
            if k & 1:
                res = tuple(_gf2_apply(sq, c) for c in res)
            k >>= 1
            if k:
                sq = tuple(_gf2_apply(sq, c) for c in sq)
        op = _ZEROS[n] = res
    return op


def _gf2_apply(cols: Tuple[int, ...], v: int) -> int:
    r, i = 0, 0
    while v:
        if v & 1:
            r ^= cols[i]
        v >>= 1
        i += 1
    return r


def _zeros_one_byte() -> Tuple[int, ...]:
    bit = (_POLY,) + tuple(1 << (i - 1) for i in range(1, 32))
    for _ in range(3):                      # 1 bit -> 2 -> 4 -> 8 bits
        bit = tuple(_gf2_apply(bit, c) for c in bit)
    return bit


_ZEROS: Dict[int, Tuple[int, ...]] = {1: _zeros_one_byte()}
_ZERO_TABLES: Dict[int, List] = {}


def _zeros_tables(n: int):
    """Z_n as four byte tables: Z_n(c) = XOR_j T_j[byte j of c]."""
    tabs = _ZERO_TABLES.get(n)
    if tabs is None:
        import numpy as np
        cols = np.asarray(_zeros_op(n), dtype=np.uint32)
        v = np.arange(256, dtype=np.uint32)
        tabs = []
        for j in range(4):
            acc = np.zeros(256, dtype=np.uint32)
            for bit in range(8):
                acc ^= np.where((v >> bit) & 1, cols[8 * j + bit],
                                np.uint32(0))
            tabs.append(acc)
        _ZERO_TABLES[n] = tabs
    return tabs


def _np_tables():
    if not _NP_TABLES:
        import numpy as np
        if not _CRC32C_TABLE:
            _crc32c_build_table()
        t = [np.asarray(_CRC32C_TABLE, dtype=np.uint32)]
        for _ in range(7):                  # t[k]: byte then k zero bytes
            p = t[-1]
            t.append((p >> 8) ^ t[0][p & 0xFF])
        i = np.arange(1 << 16, dtype=np.uint32)
        _NP_TABLES.extend(t[7 - 2 * j][i & 0xFF] ^ t[6 - 2 * j][i >> 8]
                          for j in range(4))
    return _NP_TABLES


def _np_raw(buf) -> int:
    """raw CRC of ``buf`` (uint8, a multiple of ``_NP_LANE`` bytes)."""
    import numpy as np
    u0, u1, u2, u3 = _np_tables()
    m = buf.shape[0] // _NP_LANE
    words = buf.view(np.uint32).reshape(m, _NP_LANE // 4).T
    lo = np.ascontiguousarray(words[0::2])  # step k: lane words k, all lanes
    hi = np.ascontiguousarray(words[1::2])
    crc = np.zeros(m, dtype=np.uint32)
    x, i, g = (np.empty(m, dtype=np.uint32) for _ in range(3))
    for k in range(lo.shape[0]):
        np.bitwise_xor(lo[k], crc, out=x)
        np.take(u0, np.bitwise_and(x, 0xFFFF, out=i), out=crc)
        crc ^= np.take(u1, np.right_shift(x, 16, out=i), out=g)
        crc ^= np.take(u2, np.bitwise_and(hi[k], 0xFFFF, out=i), out=g)
        crc ^= np.take(u3, np.right_shift(hi[k], 16, out=i), out=g)
    # leading zero lanes leave raw unchanged: pad to a power of two
    pad = (1 << (m - 1).bit_length()) - m
    if pad:
        crc = np.concatenate([np.zeros(pad, dtype=np.uint32), crc])
    seg = _NP_LANE
    while crc.shape[0] > 1:
        t0, t1, t2, t3 = _zeros_tables(seg)
        a = crc[0::2]
        crc = (t0[a & 0xFF] ^ t1[(a >> 8) & 0xFF] ^ t2[(a >> 16) & 0xFF]
               ^ t3[a >> 24] ^ crc[1::2])
        seg *= 2
    return int(crc[0])


def _np_crc32c(data) -> int:
    """CRC32C of a bytes-like object by chunked numpy slicing-by-8."""
    n = len(data)
    if n < _NP_MIN:
        return _py_crc32c(data)
    import numpy as np
    _note_py_crc32c(n)
    buf = np.frombuffer(data, dtype=np.uint8)
    full = n - n % _NP_LANE
    blocks = [buf[s:min(s + _NP_BLOCK, full)]
              for s in range(0, full, _NP_BLOCK)]
    _np_tables()
    if len(blocks) > 2:
        # threads pay only on whole blocks: smaller ones lose more to the
        # GIL between numpy calls than they gain
        if not _NP_POOL:
            import os
            from concurrent.futures import ThreadPoolExecutor
            _NP_POOL.append(ThreadPoolExecutor(min(8, os.cpu_count() or 1)))
        raws = list(_NP_POOL[0].map(_np_raw, blocks))
    else:
        raws = [_np_raw(b) for b in blocks]
    reg = 0xFFFFFFFF
    for b, raw in zip(blocks, raws):
        reg = _gf2_apply(_zeros_op(len(b)), reg) ^ raw
    return _crc32c_bytes(reg, buf[full:]) ^ 0xFFFFFFFF


try:                                       # C implementation when present
    from google_crc32c import value as _crc32c_impl

    CRC32C_IMPL = "google-crc32c"

    def crc32c(data: bytes) -> int:
        # the C entry refuses memoryviews and writable buffers but takes a
        # numpy array: pack lanes arrive as views of arrays and buffers
        import numpy as np
        return _crc32c_impl(np.frombuffer(data, dtype=np.uint8))
except ImportError:                        # chunked numpy fallback
    CRC32C_IMPL = "numpy-sliced"
    crc32c = _np_crc32c


def encode_frame(payload: bytes) -> bytes:
    """One durable frame: length + crc32c + payload."""
    return _FRAME_HEAD.pack(len(payload), crc32c(payload)) + payload


def check_store_header(blob: bytes) -> int:
    """Validate the store header; returns the offset where frames begin.

    Returns ``-1`` for a recognized LEGACY headerless pickle store (pickle
    protocol 2+ opcode ``\\x80``); raises :class:`StoreVersionError` for
    anything else."""
    if blob.startswith(MAGIC):
        version = blob[4]
        if version != STORE_VERSION:
            raise StoreVersionError(
                f"store format version {version} is not supported")
        if len(blob) < len(STORE_HEADER):
            raise StoreVersionError("store header truncated")
        return len(STORE_HEADER)
    if blob[:1] == b"\x80":
        return -1
    raise StoreVersionError(
        f"bad magic {blob[:4]!r}: not a datagit WAL store")


def iter_frames(blob: bytes, offset: int) -> Iterator[Tuple[bytes, int]]:
    """Yield ``(payload, end_offset)`` per frame, verifying each CRC.

    Raises :class:`TornFrame` when the trailing frame extends past EOF
    (including a torn length/crc prefix) and :class:`CorruptFrame` on a
    CRC mismatch; there is no silent resync."""
    size = len(blob)
    idx = 0
    while offset < size:
        if size - offset < FRAME_OVERHEAD:
            raise TornFrame(offset, bytes(blob[offset:]))
        length, crc = _FRAME_HEAD.unpack_from(blob, offset)
        end = offset + FRAME_OVERHEAD + length
        if end > size:
            raise TornFrame(offset, bytes(blob[offset:]))
        payload = blob[offset + FRAME_OVERHEAD:end]
        if crc32c(payload) != crc:
            raise CorruptFrame(
                idx, offset,
                f"crc mismatch over {length} payload byte(s)")
        yield payload, end
        offset = end
        idx += 1


def dump_records(records: Sequence[WalRecord]) -> bytes:
    """Pickle records for a frame, every tensor in them as numpy."""
    return pickle.dumps([WalRecord(r.kind, host_tree(r.payload))
                         for r in records],
                        protocol=pickle.HIGHEST_PROTOCOL)


class WAL:
    def __init__(self):
        self.records: List[WalRecord] = []
        # telemetry counters (wal.frames / wal.bytes / wal.fsyncs) — live
        # process state only, never pickled: ``serialize`` ships just the
        # records, so a replayed engine always starts these at zero
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

    def serialize(self) -> bytes:
        return STORE_HEADER + encode_frame(dump_records(self.records))

    @staticmethod
    def deserialize(blob: bytes) -> "WAL":
        w = WAL()
        start = check_store_header(blob)
        if start < 0:                       # legacy headerless pickle blob
            w.records = pickle.loads(blob)
            return w
        for payload, _ in iter_frames(blob, start):
            w.records.extend(pickle.loads(payload))
        return w
