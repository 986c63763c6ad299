"""Registry of the architectures the port serves so far: the paper's
Qwen3 models, Gemma2-9B (sliding-window and global layers, softcaps,
head_dim 256, tied head) and Mamba2-1.3B (attention-free Mamba2 layers,
no FFN, tied head; the static engine serves it, the paged cache of the
continuous engine does not).

``get_config(name)`` returns the full-size config; ``smoke(name)`` the
reduced same-family variant the CPU tests use. Other families join as
their slices land (ROADMAP queue 1).
"""
from repro_torch.config import ModelConfig, smoke_variant
from repro_torch.configs.gemma2_9b import CONFIG as _gemma2
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2
from repro_torch.configs.qwen3_paper import CONFIG as _qwen3
from repro_torch.configs.qwen3_paper import CONFIG_8B as _qwen3_8b

PAPER_ARCHS = {c.name: c for c in (_qwen3, _qwen3_8b)}
ARCHS = {c.name: c for c in (_gemma2, _mamba2)}
ALL = {**ARCHS, **PAPER_ARCHS}


def get_config(name: str) -> ModelConfig:
    try:
        return ALL[name]
    except KeyError as e:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ALL)}") from e


def smoke(name: str, **over) -> ModelConfig:
    return smoke_variant(get_config(name), **over)
