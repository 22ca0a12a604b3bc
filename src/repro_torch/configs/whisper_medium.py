"""whisper-medium — audio encoder-decoder transformer backbone.

The conv frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S, d_model). The decoder is a causal
transformer with a cross-attention sublayer to the encoder's output in
every layer and learned absolute positions. [arXiv:2212.04356;
unverified]
"""
from .base import ArchConfig, register


@register
def whisper_medium() -> ArchConfig:
    return ArchConfig(
        name="whisper-medium", family="audio",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab=51865,
        encoder_layers=24,
        period=1, slots=("attn",),         # decoder self-attn; cross added
        rope=False, learned_pos=True, max_seq=65536,
        source="arXiv:2212.04356; unverified",
    )
