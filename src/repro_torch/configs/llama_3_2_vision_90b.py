"""llama-3.2-vision-90b — VLM backbone: 100 layers with a cross-attention
image layer every 5th layer. The vision tower is a stub, as in the
reference: the cross layers take precomputed patch embeddings (B,
cross_len, d_model). [hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from .base import ArchConfig, register


@register
def llama_3_2_vision_90b() -> ArchConfig:
    return ArchConfig(
        name="llama-3.2-vision-90b", family="vlm",
        n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=28672, vocab=128256,
        period=5, slots=("cross", "attn", "attn", "attn", "attn"),
        cross_len=6404,     # 4 images x 1601 patch embeddings (stub frontend)
        source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
    )
