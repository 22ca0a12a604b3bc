"""mixtral-8x7b — 8-expert top-2 MoE with sliding-window attention (4096).
SWA bounds the KV cache, making 500k-context decode feasible (long_500k
eligible). [arXiv:2401.04088; hf]"""
from .base import ArchConfig, MoECfg, register


@register
def mixtral_8x7b() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=32000,
        sliding_window=4096,
        moe=MoECfg(n_experts=8, top_k=2, every=1),
        source="arXiv:2401.04088; hf",
    )
