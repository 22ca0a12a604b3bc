"""Deterministic fault injection: named crash points.

The port's own copy of ``repro.core.faults`` (the port imports nothing of
the reference package). Every durability-critical seam calls
:func:`crash_point` with a name REGISTERED at import time
(:func:`register`), so tests can enumerate every seam (``registered()``)
and kill the process at each one in turn; a :class:`FaultPlan` armed with
:func:`inject` trips the *n*-th hit of a name by raising
:class:`InjectedCrash`.

The port registers its seams under a ``torch.`` prefix: crash-point names
are keyed project-wide by the reference's lint, and shared names would
alias the reference's seams and hide gaps in its coverage.

:func:`flip_bit` / :func:`truncate_file` inject storage corruption into
store and pack files, and :func:`corrupt_object_bit` flips a bit inside a
sealed object on its device — the integrity layer (CRC frames,
``core.fsck``) must report each as a typed error, never a silent wrong
answer.

Cost when disarmed: ``crash_point`` is one global load + ``is None`` test.
Seams are per *operation*, never per row.
"""
from __future__ import annotations

import os
from collections import Counter
from contextlib import contextmanager
from typing import Dict, Iterator, Optional

__all__ = ["InjectedCrash", "FaultPlan", "register", "registered",
           "crash_point", "inject", "flip_bit", "truncate_file",
           "corrupt_object_bit"]


class InjectedCrash(BaseException):
    """The simulated ``kill -9``: raised by a tripped crash point.

    A ``BaseException`` on purpose — generic ``except Exception`` cleanup
    handlers must not swallow it, exactly as they would not run under a
    real crash."""

    def __init__(self, point: str, hit: int):
        super().__init__(f"injected crash at {point!r} (hit #{hit})")
        self.point = point
        self.hit = hit


#: name -> human description of the seam, populated at import time
_REGISTRY: Dict[str, str] = {}

#: the armed plan (None = disarmed); arming is a test-harness operation
_ACTIVE: Optional["FaultPlan"] = None


def register(name: str, doc: str) -> str:
    """Register a crash-point name at import time; returns the name so the
    owning module can bind it to a constant."""
    if _REGISTRY.get(name, doc) != doc:
        raise ValueError(f"crash point {name!r} registered twice "
                         "with different docs")
    _REGISTRY[name] = doc
    return name


def registered() -> Dict[str, str]:
    """Every registered crash point (name -> doc)."""
    return dict(_REGISTRY)


def crash_point(name: str) -> None:
    """Durability seam marker: no-op unless a FaultPlan is armed."""
    if _ACTIVE is None:
        return
    _ACTIVE._hit(name)


class FaultPlan:
    """Trip-on-Nth-hit plan over registered crash points."""

    def __init__(self, trips: Optional[Dict[str, int]] = None):
        self.trips: Dict[str, int] = dict(trips or {})
        for name, n in self.trips.items():
            if name not in _REGISTRY:
                raise KeyError(f"unknown crash point {name!r} "
                               f"(registered: {sorted(_REGISTRY)})")
            if n < 1:
                raise ValueError(f"trip count for {name!r} is 1-based")
        self.hits: Counter = Counter()
        self.tripped: Optional[str] = None

    @classmethod
    def at(cls, name: str, n: int = 1) -> "FaultPlan":
        return cls({name: n})

    def _hit(self, name: str) -> None:
        if name not in _REGISTRY:
            raise KeyError(f"crash_point({name!r}) is not registered")
        self.hits[name] += 1
        n = self.trips.get(name)
        if n is not None and self.hits[name] == n and self.tripped is None:
            self.tripped = name
            raise InjectedCrash(name, n)


@contextmanager
def inject(plan: FaultPlan) -> Iterator[FaultPlan]:
    """Arm ``plan`` for the duration of the block (no nesting)."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a FaultPlan is already armed")
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = None


# --------------------------------------------------------------------------
# corruption injectors — storage-level bit rot, deterministically placed
# --------------------------------------------------------------------------

def flip_bit(path: str, byte_offset: int, bit: int = 0) -> None:
    """Flip one bit of a file in place (single-bit storage corruption)."""
    size = os.path.getsize(path)
    if not 0 <= byte_offset < size:
        raise ValueError(f"offset {byte_offset} outside file of {size} bytes")
    with open(path, "r+b") as f:
        f.seek(byte_offset)
        b = f.read(1)[0]
        f.seek(byte_offset)
        f.write(bytes([b ^ (1 << (bit & 7))]))


def truncate_file(path: str, size: int) -> None:
    """Cut a file at ``size`` bytes (a torn write / lost tail)."""
    with open(path, "r+b") as f:
        f.truncate(size)


def corrupt_object_bit(obj, column: Optional[str] = None, row: int = 0,
                       bit: int = 0) -> None:
    """Flip one bit inside a sealed object's payload (in-memory bit rot).

    ``column=None`` corrupts the first fixed-width column; a LOB column
    corrupts one byte of the row's value. The object's carried signatures
    are left untouched — ``core.fsck`` must flag the mismatch.

    The lane is REPLACED by a rotted copy, never written in place: a
    sanitized lane is an inference-mode tensor that refuses in-place
    writes, and the injector must plant bit rot without tripping the
    sanitizer it is there to exercise."""
    import numpy as np
    import torch
    if column is None:
        column = next(c for c, a in obj.cols.items() if torch.is_tensor(a))
    lane = obj.cols[column]
    if torch.is_tensor(lane):
        arr = lane.clone()
        flat = arr.view(torch.uint8).reshape(-1)
        flat[row * lane.element_size()] ^= 1 << (bit & 7)
    else:                                       # LOB: mutate one byte
        arr = np.array(lane, dtype=object)
        v = bytearray(arr[row])
        v[0] ^= 1 << (bit & 7)
        arr[row] = bytes(v)
    # lint: seal-ok deliberate corruption injector — swaps in a rotted
    # copy so fsck/CRC layers can be tested against in-memory bit flips
    obj.cols[column] = arr
