"""Llama-3.2-11B-Vision [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, cross-attention image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision]

The vision encoder (ViT) + projector is a STUB per the assignment carve-out:
``input_specs`` provides precomputed patch embeddings (B, 1601, d_model) that
the cross-attention layers consume as memory."""
from repro_torch.config import ATTN, CROSS, MLP, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    # 8 cross-attn layers interleaved among 40 -> period-5 blocks.
    block_pattern=(ATTN, ATTN, ATTN, ATTN, CROSS),
    ffn_pattern=(MLP,),
    memory_seq=1601,          # 560/14 patches^2 + CLS
    rope_theta=500_000.0,
)
