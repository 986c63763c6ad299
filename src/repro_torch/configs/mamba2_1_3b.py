"""Mamba2-1.3B [ssm]: 48 Mamba2 layers, d_model 2048, attention-free (SSD,
state-space duality), no FFN, d_inner 4096 in 64 SSM heads of 64
channels, state 128, one B/C group, conv width 4, chunk 256, vocab 50280,
head tied to the embedding. [arXiv:2405.21060]"""
from repro_torch.config import MAMBA, NONE, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    block_pattern=(MAMBA,),
    ffn_pattern=(NONE,),
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    tie_embeddings=True,
)
