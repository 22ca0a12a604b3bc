"""deepseek-7b — dense llama-arch LM, MHA (kv=32).
[arXiv:2401.02954; hf]"""
from .base import ArchConfig, register


@register
def deepseek_7b() -> ArchConfig:
    return ArchConfig(
        name="deepseek-7b", family="dense",
        n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=11008, vocab=102400,
        source="arXiv:2401.02954; hf",
    )
