"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave with
MoE(16e, top-2) every other layer. Attention layers use GQA kv=8 and no
positional encoding (Mamba layers carry position). [arXiv:2403.19887; hf]

The Mamba mixer runs in the SSD (matmul/chunked) formulation of
``models.ssm``, as the reference computes it.
"""
from .base import ArchConfig, MoECfg, SSMCfg, register


@register
def jamba_1_5_large_398b() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=24576, vocab=65536,
        period=8,
        slots=("mamba", "mamba", "mamba", "mamba",
               "attn", "mamba", "mamba", "mamba"),
        ffn_slots=("mlp", "moe", "mlp", "moe", "mlp", "moe", "mlp", "moe"),
        moe=MoECfg(n_experts=16, top_k=2, every=2),
        ssm=SSMCfg(kind="mamba", d_state=16, head_dim=64, d_conv=4, expand=2),
        rope=False,
        source="arXiv:2403.19887; hf",
    )
