"""Architecture configs of the model stack, as plain data.

The port's copy of ``repro.configs.base`` (the subset the serving and
training paths read): the same fields, defaults, ``reduced()`` shrink and
parameter counts, so a config name selects the same architecture in both
packages, and the step shape (``ShapeCfg``) that ``launch.steps`` sizes
its inputs by. Registered configs are listed in ``configs/__init__.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int = 2
    every: int = 1          # MoE FFN every k-th layer (1 = all layers)
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMCfg:
    kind: str = "mamba"     # "mamba" (SSD form) | "rwkv6"
    d_state: int = 16       # mamba state size / rwkv6 key head dim
    head_dim: int = 64      # channels per decay head
    d_conv: int = 4         # mamba causal conv width
    expand: int = 2         # mamba inner expansion


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None    # default d_model // n_heads
    qkv_bias: bool = False
    rope: bool = True
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None      # SWA (mixtral)
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    # layer pattern: period length and the slot kinds within one period
    period: int = 1
    slots: Tuple[str, ...] = ("attn",)        # attn | mamba | rwkv | cross
    ffn_slots: Optional[Tuple[str, ...]] = None  # mlp | moe (default all mlp
    #                                              or all moe if moe set)
    encoder_layers: int = 0                   # encoder-decoder (whisper)
    cross_len: int = 0                        # cross-attention context length
    learned_pos: bool = False                 # whisper-style abs positions
    max_seq: int = 8192                       # learned-pos table size
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        if self.n_layers % self.period:
            raise ValueError(f"{self.name}: {self.n_layers} layers do not "
                             f"divide into periods of {self.period}")
        return self.n_layers // self.period

    def slot_kinds(self) -> Tuple[str, ...]:
        if len(self.slots) != self.period:
            raise ValueError(f"{self.name}: {len(self.slots)} slots for "
                             f"period {self.period}")
        return self.slots

    def ffn_kinds(self) -> Tuple[str, ...]:
        if self.ffn_slots is not None:
            if len(self.ffn_slots) != self.period:
                raise ValueError(f"{self.name}: {len(self.ffn_slots)} ffn "
                                 f"slots for period {self.period}")
            return self.ffn_slots
        kind = "moe" if self.moe else "mlp"
        return tuple(kind for _ in range(self.period))

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def n_params(self) -> float:
        """Approximate parameter count (for 6ND roofline math): the
        reference's formula, which leaves out norms, QKV biases and the
        MoE router."""
        d, hd = self.d_model, self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        mlp = 3 * d * self.d_ff     # gated
        total = 0.0
        for s, f in zip(self.slot_kinds(), self.ffn_kinds()):
            if s in ("attn", "cross"):
                total += attn
            elif s == "mamba":
                di = self.ssm.expand * d
                total += 2 * d * di + di * d + di * (2 * self.ssm.d_state + 2)
            elif s == "rwkv":
                total += 4 * d * d + d * d  # r,k,v,g,o (+ small decay mlps)
            if f == "moe":
                total += self.moe.n_experts * 3 * d * self.d_ff
            else:
                total += mlp
        total *= self.n_periods
        if self.is_encdec:  # encoder stack: self-attn + mlp per layer
            total += self.encoder_layers * (attn + 3 * d * self.d_ff)
        total += 2 * self.vocab * d  # embed + lm head
        return float(total)

    def n_params_encoder(self) -> float:
        """Encoder-stack params only (enc-dec archs): the reference's
        formula, without the encoder's norms."""
        if not self.is_encdec:
            return 0.0
        d, hd = self.d_model, self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        return float(self.encoder_layers * (attn + 3 * d * self.d_ff))

    def n_params_active(self) -> float:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.n_params()
        moe_total = sum(self.moe.n_experts * 3 * self.d_model * self.d_ff
                        for f in self.ffn_kinds() if f == "moe")
        moe_total *= self.n_periods
        active_moe = moe_total * self.moe.top_k / self.moe.n_experts
        return self.n_params() - moe_total + active_moe

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        scale = {}
        scale["d_model"] = 64
        scale["n_heads"] = 4
        scale["n_kv_heads"] = max(1, min(self.n_kv_heads, 2))
        scale["head_dim"] = 16
        scale["d_ff"] = 128
        scale["vocab"] = 512
        scale["n_layers"] = 2 * self.period
        scale["encoder_layers"] = 2 if self.is_encdec else 0
        scale["cross_len"] = 8 if (self.cross_len or self.is_encdec) else 0
        scale["max_seq"] = 256
        if self.moe:
            scale["moe"] = MoECfg(n_experts=4, top_k=2, every=self.moe.every,
                                  capacity_factor=self.moe.capacity_factor)
        if self.ssm:
            scale["ssm"] = SSMCfg(kind=self.ssm.kind, d_state=4, head_dim=16,
                                  d_conv=self.ssm.d_conv, expand=2)
        if self.sliding_window:
            scale["sliding_window"] = 16
        return dataclasses.replace(self, **scale)


def first_layers(cfg: ArchConfig, n: int) -> ArchConfig:
    """``cfg`` cut to the first ``n`` layers of its stack, at its widths:
    whole periods, or the first ``n`` slots of one period (the period
    then shrinks to ``n``: :func:`period_slots`). The weights' init
    scale follows the cut's periods, not the published ones."""
    if n % cfg.period == 0:
        return dataclasses.replace(cfg, n_layers=n)
    if n > cfg.period:
        raise ValueError(f"{cfg.name}: {n} layers are neither whole "
                         f"periods of {cfg.period} nor part of one")
    return period_slots(cfg, tuple(range(n)))


def period_slots(cfg: ArchConfig, slots: Tuple[int, ...]) -> ArchConfig:
    """``cfg`` cut to the layers of chosen ``slots`` of its first period,
    in order, at its widths: one period of ``len(slots)`` layers, each
    keeping its slot's mixer and FFN. Picking the slots of a
    :func:`first_layers` cut whose FFN is not an MoE drops its MoE layers
    (jamba's slots 0, 2 and 4: its first five layers less the two whose
    16 experts hold 9.7 B parameters each). A cut that keeps no MoE layer
    has no ``moe``. The weights' init scale follows the cut's one period,
    not the published periods."""
    kinds, ffns = cfg.slot_kinds(), cfg.ffn_kinds()
    if not slots or sorted(set(slots)) != list(slots) \
            or not 0 <= slots[0] <= slots[-1] < cfg.period:
        raise ValueError(f"{cfg.name}: slots {slots} are not increasing "
                         f"slots of a period of {cfg.period}")
    ffn = tuple(ffns[i] for i in slots)
    return dataclasses.replace(
        cfg, n_layers=len(slots), period=len(slots),
        slots=tuple(kinds[i] for i in slots), ffn_slots=ffn,
        moe=cfg.moe if "moe" in ffn else None)


# ---------------------------------------------------------------- shapes

@dataclass(frozen=True)
class ShapeCfg:
    """One step's sizes (the reference's): ``seq_len`` tokens (an
    encoder-decoder config's frames), ``global_batch`` rows, and the
    step's ``kind``: train | prefill | decode."""
    name: str
    seq_len: int
    global_batch: int
    kind: str


#: the dry run's (arch x shape) cells: the reference's shapes, in its order
LM_SHAPES: Dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}

# archs whose attention is sub-quadratic in context (SSM state, hybrid with
# sparse attention, or bounded sliding window): eligible for long_500k
SUBQUADRATIC = {"rwkv6-7b", "jamba-1.5-large-398b", "mixtral-8x7b"}


def cells_for(arch: ArchConfig):
    """The (arch x shape) dry-run cells of ``arch``: every shape of
    :data:`LM_SHAPES` in order, long_500k only if it is sub-quadratic."""
    return [s for s in LM_SHAPES.values()
            if s.name != "long_500k" or arch.name in SUBQUADRATIC]


_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register(fn: Callable[[], ArchConfig]):
    cfg = fn()
    _REGISTRY[cfg.name] = fn
    return fn


def get_config(name: str) -> ArchConfig:
    from . import ALL  # noqa: F401  (forces registration of all configs)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def all_arch_names():
    from . import ALL  # noqa: F401
    return sorted(_REGISTRY.keys())
