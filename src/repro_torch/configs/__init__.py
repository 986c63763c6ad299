"""Registry of the architectures the port serves so far: the paper's
Qwen3 models; the dense InternLM2-1.8B, Qwen2-7B and Qwen1.5-32B (QKV
bias); Gemma2-9B (sliding-window and global layers, softcaps, head_dim
256, tied head); the MoE Llama-4 Scout and Maverick (top-1 routing over
16 / 128 experts with a shared expert, Maverick interleaving MoE and
dense FFN layers); Mamba2-1.3B (attention-free Mamba2 layers, no FFN,
tied head; the static engine serves it, the paged cache of the continuous
engine does not); the hybrid Jamba-1.5-Large (one attention layer to
seven Mamba2 layers, MoE on every other layer); and the modality-memory
families, Llama-3.2-11B-Vision (a cross-attention layer every fifth layer
over a stub memory of 1601 patch embeddings) and Whisper-small (an
encoder over 1500 stub frame embeddings, a decoder cross-attending to its
output in every layer). Memory and encoder-decoder models serve static:
the paged cache refuses them, as the JAX package's does.

``get_config(name)`` returns the full-size config; ``smoke(name)`` the
reduced same-family variant the CPU tests use; ``supports_shape`` says
which of the dry-run's input shapes an arch runs (``long_500k`` only for
``LONG_CONTEXT_OK``).
"""
from repro_torch.config import ModelConfig, smoke_variant
from repro_torch.configs.gemma2_9b import CONFIG as _gemma2
from repro_torch.configs.internlm2_1_8b import CONFIG as _internlm2
from repro_torch.configs.jamba1_5_large_398b import CONFIG as _jamba
from repro_torch.configs.llama3_2_vision_11b import CONFIG as _llama32v
from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG as _maverick
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as _scout
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2
from repro_torch.configs.qwen1_5_32b import CONFIG as _qwen15_32b
from repro_torch.configs.qwen2_7b import CONFIG as _qwen2
from repro_torch.configs.qwen3_paper import CONFIG as _qwen3
from repro_torch.configs.qwen3_paper import CONFIG_8B as _qwen3_8b
from repro_torch.configs.whisper_small import CONFIG as _whisper

PAPER_ARCHS = {c.name: c for c in (_qwen3, _qwen3_8b)}
ARCHS = {c.name: c for c in (_qwen15_32b, _llama32v, _jamba, _scout,
                             _gemma2, _maverick, _whisper, _internlm2,
                             _mamba2, _qwen2)}
ALL = {**ARCHS, **PAPER_ARCHS}

# The architectures with a sub-quadratic (or natively windowed) path that
# run the long_500k decode shape; every other one skips it.
LONG_CONTEXT_OK = frozenset({"mamba2-1.3b", "jamba-1.5-large-398b",
                             "gemma2-9b"})


def get_config(name: str) -> ModelConfig:
    try:
        return ALL[name]
    except KeyError as e:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ALL)}") from e


def smoke(name: str, **over) -> ModelConfig:
    return smoke_variant(get_config(name), **over)


def supports_shape(name: str, shape_name: str) -> bool:
    """Whether arch ``name`` runs the input shape ``shape_name``: every
    shape but long_500k, which only ``LONG_CONTEXT_OK`` runs (Whisper's
    decoder takes the 32k shapes, its encoder memory at its own frame
    count)."""
    get_config(name)
    if shape_name == "long_500k":
        return name in LONG_CONTEXT_OK
    return True
