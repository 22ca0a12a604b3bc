"""Content-addressed pack files: the durable spill tier, DGPK v1.

One sealed object per pack file, in the DGWS framing style of the WAL::

    header  := MAGIC "DGPK" | version u8 | reserved u8*3       (8 bytes)
    frame 0 := meta (canonical JSON: kind, lane layout, dtypes)
    frame i := one lane payload per meta["lanes"] entry
    frame   := length u32le | crc32c(payload) u32le | payload

The format is the reference's byte for byte: the same meta, the same frame
order, and every word lane (signatures, commit_ts, tombstone targets, LOB
signatures) coded ``<u8`` although the port holds it as int64 bits. So a
pack written by either package decodes in the other — the cross-package
check, since a pack holds no pickle.

Lanes cross the host boundary here as numpy (``interop``): encode reads
each lane off the device once; decode uploads each numeric lane to the
store's device once (a NoPK object's key lanes stay its row lanes). LOB
lanes (host object arrays of ``bytes``) are a u64le count, a u32le length
lane, then the concatenated values.

The content address is ``sha256(blob)`` with the **oid excluded** from the
meta frame: oids are recycled by the engine's rollback paths, so a digest
keyed on one would alias a recycled oid to stale bytes. ``PackDir.load``
re-binds the requesting oid at decode time.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..core.faults import crash_point, register
from ..core.objects import DataObject, TombstoneObject
from ..core.wal import _FRAME_HEAD, StoreFormatError, crc32c, iter_frames
from ..interop import to_numpy

PACK_MAGIC = b"DGPK"
PACK_VERSION = 1
PACK_HEADER = PACK_MAGIC + bytes([PACK_VERSION]) + b"\x00\x00\x00"
PACK_SUFFIX = ".dgp"

CP_TORCH_STORE_PACK_WRITE = register(
    "torch.store.pack.write",
    "mid atomic pack/refs file write: the tmp file is fully written but "
    "not yet renamed into place — recovery must see either the old file "
    "or none (the stale .tmp is ignored by every reader)")

_LOB_HEAD = struct.Struct("<Q")           # value count of a LOB lane
_WORD = "<u8"                             # code of every 64-bit word lane


class PackFormatError(StoreFormatError):
    """A pack blob failed structural validation (magic/version/layout)."""


# --------------------------------------------------------------------------
# lane codecs
# --------------------------------------------------------------------------

def _lob_parts(arr: np.ndarray) -> List:
    vals = [v if isinstance(v, bytes) else bytes(v) for v in arr.tolist()]
    lens = np.fromiter(map(len, vals), dtype=np.uint32, count=len(vals))
    return [_LOB_HEAD.pack(len(vals)), lens.tobytes(), b"".join(vals)]


def _decode_lob_lane(payload) -> np.ndarray:
    if len(payload) < _LOB_HEAD.size:
        raise PackFormatError("LOB lane truncated before its count")
    (n,) = _LOB_HEAD.unpack_from(payload, 0)
    off = _LOB_HEAD.size
    if off + 4 * n > len(payload):
        raise PackFormatError("LOB lane length table does not cover payload")
    lens = np.frombuffer(payload, dtype=np.uint32, count=n, offset=off)
    off += n * 4
    if off + int(lens.sum(dtype=np.int64)) != len(payload):
        raise PackFormatError("LOB lane length table does not cover payload")
    data = bytes(payload[off:])
    ends = np.cumsum(lens, dtype=np.int64).tolist()
    out = np.empty((n,), dtype=object)
    out[:] = [data[s:e] for s, e in zip([0] + ends[:-1], ends)]
    return out


def _lane_dtype(code) -> np.dtype:
    """The host dtype a lane code decodes to (``<u8`` words as int64)."""
    try:
        dt = np.dtype(code)
    except TypeError:
        raise PackFormatError(f"unsupported lane dtype {code!r}") from None
    if dt.str == _WORD:
        return np.dtype(np.int64)           # the port's words: int64 bits
    if dt.str not in ("<i8", "<i4", "<f8", "<f4", "|b1"):
        raise PackFormatError(f"unsupported lane dtype {code!r}")
    return dt


def _decode_num_lane(payload, dt: np.dtype, device) -> torch.Tensor:
    """One upload of a lane to ``device``. A read-only buffer is copied
    first (and a CPU lane always is, aligned and private): never a
    writable tensor over memory that is not its own."""
    if device.type == "cpu" or payload.readonly or not len(payload):
        return torch.from_numpy(np.frombuffer(payload, dtype=dt).copy()
                                ).to(device)
    tdt = torch.from_numpy(np.empty(0, dtype=dt)).dtype
    return torch.frombuffer(payload, dtype=tdt).to(device)


# --------------------------------------------------------------------------
# object <-> blob
# --------------------------------------------------------------------------

def _frame_parts(parts: List) -> List:
    n = sum(len(p) for p in parts)
    payload = parts[0] if len(parts) == 1 else b"".join(parts)
    return [_FRAME_HEAD.pack(n, crc32c(payload)), payload]


def encode_object(obj) -> bytes:
    """Serialize one sealed object as a self-verifying pack blob.

    Deterministic: identical lane content encodes to identical bytes (the
    reference's bytes), so the digest doubles as the dedup/exchange key."""
    lanes: List[Tuple[str, str, List]] = []   # (name, codec, payload parts)

    def num(name: str, t: torch.Tensor, word: bool = True) -> None:
        a = np.ascontiguousarray(to_numpy(t, u64=word))
        lanes.append((name, a.dtype.str, [memoryview(a).cast("B")]))

    if isinstance(obj, DataObject):
        key_is_row = obj.key_lo is obj.row_lo
        num("commit_ts", obj.commit_ts)
        num("row_lo", obj.row_lo)
        num("row_hi", obj.row_hi)
        if not key_is_row:
            num("key_lo", obj.key_lo)
            num("key_hi", obj.key_hi)
        cols: List[Tuple[str, str]] = []
        for name, col in obj.cols.items():
            if torch.is_tensor(col):
                num(name, col, word=False)
                cols.append((name, lanes[-1][1]))
            else:
                cols.append((name, "lob"))
                lanes.append((name, "lob", _lob_parts(col)))
        sig_lob = sorted(obj.lob_sigs)
        for name in sig_lob:
            num("lob_sig:" + name, obj.lob_sigs[name])
        meta = {"kind": "data", "nrows": int(obj.nrows),
                "nbytes": int(obj.nbytes), "key_is_row": key_is_row,
                "cols": cols, "sig_lob": sig_lob,
                "lanes": [(n, c) for n, c, _ in lanes]}
    elif isinstance(obj, TombstoneObject):
        num("commit_ts", obj.commit_ts)
        num("target", obj.target)
        num("key_lo", obj.key_lo)
        num("key_hi", obj.key_hi)
        meta = {"kind": "tomb", "nrows": int(obj.nrows),
                "target_oids": [int(o) for o in obj.target_oids],
                "lanes": [(n, c) for n, c, _ in lanes]}
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")

    out = [PACK_HEADER]
    out += _frame_parts([json.dumps(meta, sort_keys=True,
                                    separators=(",", ":")).encode()])
    for _, _, parts in lanes:
        out += _frame_parts(parts)
    return b"".join(out)


def blob_digest(blob) -> str:
    return hashlib.sha256(blob).hexdigest()


def check_pack_header(blob) -> int:
    """Validate the pack header; returns the offset where frames begin."""
    if bytes(blob[:4]) != PACK_MAGIC:
        raise PackFormatError(
            f"bad magic {bytes(blob[:4])!r}: not a datagit pack file")
    if len(blob) < len(PACK_HEADER):
        raise PackFormatError("pack header truncated")
    if blob[4] != PACK_VERSION:
        raise PackFormatError(
            f"pack format version {blob[4]} is not supported "
            f"(this build reads DGPK v{PACK_VERSION})")
    return len(PACK_HEADER)


def decode_object(blob, oid: int, device="cpu"):
    """Rebuild a sealed object from a pack blob, bound to ``oid``, with its
    lanes on ``device``.

    Every frame CRC is verified on the way in (TornFrame/CorruptFrame are
    the same typed errors the WAL raises); lane shapes are validated
    against the meta frame before anything is uploaded."""
    device = torch.device(device)
    view = memoryview(blob)
    start = check_pack_header(view)
    frames = [payload for payload, _ in iter_frames(view, start)]
    if not frames:
        raise PackFormatError("pack has no meta frame")
    try:
        meta = json.loads(bytes(frames[0]).decode())
        lanes = meta.get("lanes", [])
        nrows = int(meta["nrows"])
        kind = meta["kind"]
    except (UnicodeDecodeError, json.JSONDecodeError, AttributeError,
            KeyError, TypeError, ValueError) as err:
        raise PackFormatError(f"bad meta frame: {err}") from None
    if len(frames) - 1 != len(lanes):
        raise PackFormatError(
            f"pack has {len(frames) - 1} lane frame(s), meta declares "
            f"{len(lanes)}")
    dtypes = {}
    for (name, codec), payload in zip(lanes, frames[1:]):
        if codec != "lob":
            dt = dtypes[name] = _lane_dtype(codec)
            if len(payload) != nrows * dt.itemsize:
                raise PackFormatError(
                    f"lane {name!r} has {len(payload) / dt.itemsize:g} "
                    f"row(s), meta declares {nrows}")
    decoded: Dict[str, object] = {}
    for (name, codec), payload in zip(lanes, frames[1:]):
        decoded[name] = (_decode_lob_lane(payload) if codec == "lob"
                         else _decode_num_lane(payload, dtypes[name],
                                               device))
    try:
        if kind == "data":
            row_lo, row_hi = decoded["row_lo"], decoded["row_hi"]
            if meta["key_is_row"]:
                # NoPK tables: the key signature IS the row signature —
                # keep the tensor identity so Δ emission tags key==row
                key_lo, key_hi = row_lo, row_hi
            else:
                key_lo, key_hi = decoded["key_lo"], decoded["key_hi"]
            return DataObject(
                oid=oid, nrows=nrows,
                cols={name: decoded[name] for name, _ in meta["cols"]},
                commit_ts=decoded["commit_ts"],
                row_lo=row_lo, row_hi=row_hi, key_lo=key_lo, key_hi=key_hi,
                lob_sigs={name: decoded["lob_sig:" + name]
                          for name in meta["sig_lob"]},
                nbytes=int(meta["nbytes"]))
        if kind == "tomb":
            return TombstoneObject(
                oid=oid, nrows=nrows, target=decoded["target"],
                key_lo=decoded["key_lo"], key_hi=decoded["key_hi"],
                commit_ts=decoded["commit_ts"],
                target_oids=tuple(meta["target_oids"]))
    except (KeyError, TypeError, ValueError) as err:
        raise PackFormatError(f"pack lanes do not match its meta: {err}") \
            from None
    raise PackFormatError(f"unknown pack kind {kind!r}")


# --------------------------------------------------------------------------
# the pack directory (tier 2)
# --------------------------------------------------------------------------

def _atomic_write(path: str, blob) -> None:
    """Durable all-or-nothing file write: tmp + fsync + rename + dir fsync.

    Readers never see a partial file — the crash point fires with the tmp
    fully written but not yet renamed, and every reader ignores ``.tmp``."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        crash_point(CP_TORCH_STORE_PACK_WRITE)
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def _read(path: str) -> bytearray:
    """A file's bytes in a private writable buffer (lanes upload from it
    without a host copy)."""
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        f.readinto(buf)
    return buf


class PackDir:
    """A local pack directory (tier 2), optionally faulting through to a
    remote directory (tier 3) for digests not yet local.

    Layout: ``<root>/objects/<sha256-hex>.dgp`` — the same layout a remote
    uses, so push/fetch are file copies keyed by digest."""

    def __init__(self, root: str, origin: Optional[str] = None):
        self.root = root
        self.objects_dir = os.path.join(root, "objects")
        self.origin = origin            # remote dir for fault-through reads
        self.metrics = None             # bound by ObjectStore.attach_packs

    # ----------------------------------------------------------- layout
    def ensure(self) -> None:
        os.makedirs(self.objects_dir, exist_ok=True)

    def path(self, digest: str) -> str:
        return os.path.join(self.objects_dir, digest + PACK_SUFFIX)

    def has(self, digest: str) -> bool:
        return os.path.exists(self.path(digest))

    def digests(self) -> Set[str]:
        if not os.path.isdir(self.objects_dir):
            return set()
        return {f[:-len(PACK_SUFFIX)] for f in os.listdir(self.objects_dir)
                if f.endswith(PACK_SUFFIX)}

    # ------------------------------------------------------------- write
    def encode(self, obj) -> Tuple[str, bytes]:
        blob = encode_object(obj)
        return blob_digest(blob), blob

    def store(self, digest: str, blob) -> bool:
        """Write a pack blob under its digest; returns False when already
        present (content-addressed: identical digest == identical bytes)."""
        if self.has(digest):
            return False
        self.ensure()
        _atomic_write(self.path(digest), blob)
        return True

    def release(self, digest: str) -> None:
        """Drop the local pack file for a GC'd digest (best-effort: a
        crash mid-sweep only leaves content-addressed garbage behind)."""
        try:
            os.unlink(self.path(digest))
        except FileNotFoundError:
            pass

    # -------------------------------------------------------------- read
    def read(self, digest: str) -> bytearray:
        """The blob for ``digest`` — local file first, then a fault-through
        fetch from ``origin`` (digest-checked, cached locally)."""
        p = self.path(digest)
        if os.path.exists(p):
            return _read(p)
        if self.origin is not None:
            blob = _read(os.path.join(self.origin, "objects",
                                      digest + PACK_SUFFIX))
            if blob_digest(blob) != digest:
                raise PackFormatError(
                    f"remote object {digest[:12]}… fails its digest")
            self.store(digest, blob)
            if self.metrics is not None:
                self.metrics.add("store.objects_pulled")
            return blob
        raise KeyError(f"no pack for digest {digest[:12]}…")

    def load(self, digest: str, oid: int, device="cpu"):
        return decode_object(self.read(digest), oid, device)

    # ------------------------------------------------------------ verify
    def verify(self, digest: str) -> List[str]:
        """Integrity issues for one digest (empty list = clean)."""
        p = self.path(digest)
        if not os.path.exists(p):
            if self.origin is not None:
                return []               # fault-through remote backs it
            return [f"pack {digest[:12]}… missing from {self.objects_dir}"]
        blob = _read(p)
        if blob_digest(blob) != digest:
            return [f"pack {digest[:12]}… content does not match its "
                    "digest (bit rot or a renamed file)"]
        try:
            start = check_pack_header(blob)
            for _ in iter_frames(memoryview(blob), start):
                pass
        except StoreFormatError as err:
            return [f"pack {digest[:12]}…: {err}"]
        return []


def attach_packs(store, root: str, origin: Optional[str] = None) -> PackDir:
    """Attach (or return the existing) pack tier of an ``ObjectStore``."""
    if store.packs is not None:
        return store.packs
    backend = PackDir(root, origin=origin)
    store.attach_packs(backend)
    return backend
