"""Fault-tolerant training-state manager on the versioned store (the
counterpart of ``repro.checkpoint.manager``).

Policy: tag a checkpoint every ``every`` steps; on a detected failure (a
non-finite loss or gradient norm, or an injected fault) roll the
checkpoint table back to the last good tag (an instant metadata restore)
and reload. Keeps a bounded set of tags; GC reclaims unpinned objects.
"""
from __future__ import annotations

import math
from typing import Any, List, Optional

from ..core import Engine
from .vcs_ckpt import VcsCheckpointer


class CheckpointManager:
    def __init__(self, engine: Engine, every: int = 50, keep: int = 3,
                 table: str = "ckpt", prefix: str = ""):
        self.engine = engine
        self.ck = VcsCheckpointer(engine, table)
        self.every = every
        self.keep = keep
        self.prefix = prefix
        self.tags: List[str] = []

    @property
    def last_tag(self) -> Optional[str]:
        return self.tags[-1] if self.tags else None

    def maybe_save(self, state, step: int) -> Optional[str]:
        if step % self.every != 0:
            return None
        tag = f"{self.prefix}step-{step}"
        self.ck.save(state, step, tag)
        self.tags.append(tag)
        while len(self.tags) > self.keep:
            old = self.tags.pop(0)
            self.engine.drop_snapshot(old)
        self.engine.gc()
        return tag

    def healthy(self, loss, grad_norm=None) -> bool:
        """Finite loss (and gradient norm, if given): floats or 0-d
        tensors."""
        ok = math.isfinite(float(loss))
        if grad_norm is not None:
            ok = ok and math.isfinite(float(grad_norm))
        return ok

    def recover(self, like_state) -> Any:
        """Roll back to the last good tag and return the restored state."""
        if self.last_tag is None:
            raise RuntimeError("no checkpoint to recover from")
        self.ck.rollback(self.last_tag)
        return self.ck.restore(self.engine.snapshots[self.last_tag],
                               like_state)

    def step_of(self, tag: str) -> int:
        return int(tag.split("-")[-1])
