"""Jamba-1.5-Large-398B [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2, Mamba:attention 7:1 interleave,
MoE every second layer. [arXiv:2403.19887]"""
from repro_torch.config import ATTN, MAMBA, MLP, MOE, ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    # one attention layer per 8 (1:7 attn:mamba interleave)
    block_pattern=(ATTN, MAMBA, MAMBA, MAMBA, MAMBA, MAMBA, MAMBA, MAMBA),
    # MoE replaces the MLP on every other layer
    ffn_pattern=(MOE, MLP),
    num_experts=16,
    experts_per_token=2,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
)
