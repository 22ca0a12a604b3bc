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

Cost when disarmed: ``crash_point`` is one global load + ``is None`` test.
Seams are per *operation*, never per row.
"""
from __future__ import annotations

from collections import Counter
from contextlib import contextmanager
from typing import Dict, Iterator, Optional

__all__ = ["InjectedCrash", "FaultPlan", "register", "registered",
           "crash_point", "inject"]


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
