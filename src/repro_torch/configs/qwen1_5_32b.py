"""Qwen1.5-32B [dense] — 64L d_model=5120 40H (GQA kv=40 == MHA)
d_ff=27392 vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-0.5B family card]"""
from repro_torch.config import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    block_pattern=(ATTN,),
    ffn_pattern=(MLP,),
    rope_theta=1_000_000.0,
)
