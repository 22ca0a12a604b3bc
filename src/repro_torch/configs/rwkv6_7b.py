"""rwkv6-7b (Finch) — attention-free RNN with data-dependent decay;
token-shift + chunked WKV6 linear attention. O(1) decode state makes
long_500k trivial. [arXiv:2404.05892; hf]"""
from .base import ArchConfig, SSMCfg, register


@register
def rwkv6_7b() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-7b", family="ssm",
        n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
        d_ff=14336, vocab=65536,
        period=1, slots=("rwkv",),
        ssm=SSMCfg(kind="rwkv6", d_state=64, head_dim=64),
        rope=False,
        source="arXiv:2404.05892; hf",
    )
