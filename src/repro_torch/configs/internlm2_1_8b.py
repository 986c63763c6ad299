"""InternLM2-1.8B [dense] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544. [arXiv:2403.17297]"""
from repro_torch.config import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    block_pattern=(ATTN,),
    ffn_pattern=(MLP,),
    rope_theta=1_000_000.0,
)
