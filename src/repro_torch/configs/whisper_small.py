"""Whisper-small [audio] — 12L d_model=768 12H (kv=12) d_ff=3072
vocab=51865, encoder-decoder, conv/mel frontend STUB. [arXiv:2212.04356]

Per the assignment carve-out, the mel-spectrogram + conv feature extractor
is stubbed: ``input_specs`` provides precomputed frame embeddings
(B, 1500, d_model) consumed by the transformer encoder. The decoder
cross-attends to the encoder output every layer."""
from repro_torch.config import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,             # decoder layers
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    block_pattern=(ATTN,),     # decoder: self-attn + per-layer cross-attn
    ffn_pattern=(MLP,),
    encoder_layers=12,
    encoder_seq=1500,          # 30 s audio at 50 Hz after conv stride
    rope_theta=10_000.0,
)
