"""The paper's own training targets: Qwen3-1.7B and Qwen3-8B proxies
(GEPO §4.1 trains these on MATH level 3-5). [arXiv:2505.09388]"""
from repro_torch.config import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    block_pattern=(ATTN,),
    ffn_pattern=(MLP,),
    rope_theta=1_000_000.0,
)

CONFIG_8B = ModelConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    block_pattern=(ATTN,),
    ffn_pattern=(MLP,),
    rope_theta=1_000_000.0,
)
