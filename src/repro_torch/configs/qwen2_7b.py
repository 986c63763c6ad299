"""Qwen2-7B [dense] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, QKV bias. [arXiv:2407.10671]"""
from repro_torch.config import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    block_pattern=(ATTN,),
    ffn_pattern=(MLP,),
    rope_theta=1_000_000.0,
)
