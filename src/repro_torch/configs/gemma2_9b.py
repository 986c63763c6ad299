"""Gemma2-9B [dense]: 42L d_model=3584 16H (GQA kv=8, head_dim=256)
d_ff=14336 vocab=256000, alternating local (SWA 4096) / global attention,
attention logit softcap 50, final logit softcap 30, embeddings scaled by
sqrt(d_model) and tied to the head. [arXiv:2408.00118]"""
from repro_torch.config import ATTN, LOCAL, MLP, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    block_pattern=(LOCAL, ATTN),
    ffn_pattern=(MLP,),
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    scale_embed=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
)
