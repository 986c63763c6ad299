"""Llama-4-Scout-17B-16E [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.config import ATTN, MOE, ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    block_pattern=(ATTN,),
    ffn_pattern=(MOE,),
    num_experts=16,
    experts_per_token=1,
    shared_expert=True,
    rope_theta=500_000.0,
)
