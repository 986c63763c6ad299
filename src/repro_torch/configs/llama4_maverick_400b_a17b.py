"""Llama-4-Maverick-400B-A17B [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1 + shared expert, early fusion; MoE and
dense FFN layers interleave 1:1 (which is what puts the total at ~400B).
[hf:meta-llama/Llama-4-Scout-17B-16E card family]"""
from repro_torch.config import ATTN, MLP, MOE, ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    block_pattern=(ATTN, ATTN),
    ffn_pattern=(MOE, MLP),
    num_experts=128,
    experts_per_token=1,
    shared_expert=True,
    rope_theta=500_000.0,
)
