"""qwen1.5-0.5b — dense LM with QKV bias, MHA (kv=16).
[hf:Qwen/Qwen1.5-0.5B; hf]"""
from .base import ArchConfig, register


@register
def qwen1_5_0_5b() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-0.5b", family="dense",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=2816, vocab=151936, qkv_bias=True,
        source="hf:Qwen/Qwen1.5-0.5B; hf",
    )
