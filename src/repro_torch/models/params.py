"""Parameter templates and materialization.

The same template tree as the JAX package's ``repro/models/params.py``:
every leaf is declared once with its shape, initializer and logical axes,
and block leaves carry a leading stacked-block axis ``(nb, ...)``. Every
layer kind of the JAX package: self-attention (ATTN / LOCAL),
cross-attention to a modality memory (CROSS, no QKV biases), Mamba2
(MAMBA), each with an MLP, a MoE FFN or none. An encoder-decoder config
(``encoder_layers`` > 0) adds ``cross_norm`` and ``cross`` to every
decoder layer and an ``encoder`` subtree: one stacked layer dict of
``encoder_layers`` bidirectional attention + MLP layers, built from the
config with ``qkv_bias=False`` and ``num_layers=encoder_layers`` (which
sets its output-projection init scale), and the encoder's
``final_norm``.

``init_params`` draws random weights from a seeded ``torch.Generator`` on
the target device, with the JAX package's initializers (normal, zeros,
ones, and the Mamba2 ``ssm_a`` / ``ssm_dt`` draws). ``params_from_numpy``
carries the JAX package's params across as they are (Mamba2's ``A_log``,
``D`` and ``dt_bias`` in ``cfg.dtype`` too), so a parity test feeds both
packages one set of weights.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import (ATTN, CROSS, LOCAL, MAMBA, MLP, MOE, NONE,
                                ModelConfig)
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ParamTemplate:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | ssm_a | ssm_dt
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def _mlp_templates(cfg: ModelConfig) -> Dict[str, ParamTemplate]:
    d, f = cfg.d_model, cfg.d_ff
    out_scale = 0.02 / np.sqrt(2 * cfg.num_layers)
    return {
        "w_gate": ParamTemplate((d, f), ("embed", "ffn")),
        "w_up": ParamTemplate((d, f), ("embed", "ffn")),
        "w_down": ParamTemplate((f, d), ("ffn", "embed"), scale=out_scale),
    }


def _moe_templates(cfg: ModelConfig) -> Dict[str, Any]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    out_scale = 0.02 / np.sqrt(2 * cfg.num_layers)
    t: Dict[str, Any] = {
        "router": ParamTemplate((d, e), ("embed", None)),
        "w_gate": ParamTemplate((e, d, f), ("experts", "embed", "expert_ffn")),
        "w_up": ParamTemplate((e, d, f), ("experts", "embed", "expert_ffn")),
        "w_down": ParamTemplate((e, f, d), ("experts", "expert_ffn", "embed"),
                                scale=out_scale),
    }
    if cfg.shared_expert:
        t["shared"] = _mlp_templates(cfg)
    return t


def _attn_templates(cfg: ModelConfig,
                    cross: bool = False) -> Dict[str, ParamTemplate]:
    d, h = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    out_scale = 0.02 / np.sqrt(2 * max(cfg.num_layers, 1))
    t = {
        "wq": ParamTemplate((d, nq * h), ("embed", "qkv")),
        "wk": ParamTemplate((d, nkv * h), ("embed", "kv")),
        "wv": ParamTemplate((d, nkv * h), ("embed", "kv")),
        "wo": ParamTemplate((nq * h, d), ("qkv", "embed"), scale=out_scale),
    }
    if cfg.qkv_bias and not cross:
        t["bq"] = ParamTemplate((nq * h,), ("qkv",), init="zeros")
        t["bk"] = ParamTemplate((nkv * h,), ("kv",), init="zeros")
        t["bv"] = ParamTemplate((nkv * h,), ("kv",), init="zeros")
    return t


def _mamba_templates(cfg: ModelConfig) -> Dict[str, ParamTemplate]:
    d = cfg.d_model
    di, n, g, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_heads
    conv_ch = di + 2 * g * n
    fan_out = 2 * di + 2 * g * n + h      # [z, x, B, C, dt]
    out_scale = 0.02 / np.sqrt(2 * cfg.num_layers)
    return {
        "in_proj": ParamTemplate((d, fan_out), ("embed", "ssm_in")),
        "conv_w": ParamTemplate((cfg.ssm_conv, conv_ch), (None, "dinner")),
        "conv_b": ParamTemplate((conv_ch,), ("dinner",), init="zeros"),
        "A_log": ParamTemplate((h,), ("heads",), init="ssm_a"),
        "D": ParamTemplate((h,), ("heads",), init="ones"),
        "dt_bias": ParamTemplate((h,), ("heads",), init="ssm_dt"),
        "gate_norm": ParamTemplate((di,), ("dinner",), init="ones"),
        "out_proj": ParamTemplate((di, d), ("dinner", "embed"),
                                  scale=out_scale),
    }


def _layer_templates(cfg: ModelConfig, kind: str, ffn_kind: str,
                     decoder: bool = False) -> Dict[str, Any]:
    if (kind not in (ATTN, LOCAL, CROSS, MAMBA)
            or ffn_kind not in (MLP, MOE, NONE)):
        raise ValueError(f"{cfg.name}: unknown layer ({kind!r}, "
                         f"{ffn_kind!r})")
    d = cfg.d_model
    t: Dict[str, Any] = {"norm": ParamTemplate((d,), ("embed",), init="ones")}
    if kind in (ATTN, LOCAL):
        t["attn"] = _attn_templates(cfg)
        if cfg.is_encdec and decoder:      # whisper decoder: + cross-attn
            t["cross_norm"] = ParamTemplate((d,), ("embed",), init="ones")
            t["cross"] = _attn_templates(cfg, cross=True)
    elif kind == CROSS:
        t["attn"] = _attn_templates(cfg, cross=True)
    else:
        t["mamba"] = _mamba_templates(cfg)
    if ffn_kind == MLP:
        t["ffn_norm"] = ParamTemplate((d,), ("embed",), init="ones")
        t["mlp"] = _mlp_templates(cfg)
    elif ffn_kind == MOE:
        t["ffn_norm"] = ParamTemplate((d,), ("embed",), init="ones")
        t["moe"] = _moe_templates(cfg)
    return t


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack(tree: Any, n: int) -> Any:
    """Prepend a stacking dimension of size n to every template."""
    return _map(lambda t: dataclasses.replace(t, shape=(n,) + t.shape,
                                              axes=(None,) + t.axes), tree)


def param_templates(cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.padded_vocab
    block = {f"layer_{i}": _layer_templates(cfg, kind, cfg.ffn_kind(i),
                                            decoder=True)
             for i, kind in enumerate(cfg.block_pattern)}
    t: Dict[str, Any] = {
        "embed": ParamTemplate((v, d), ("vocab", "embed"), scale=1.0),
        "blocks": _stack(block, cfg.num_blocks),
        "final_norm": ParamTemplate((d,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = ParamTemplate((d, v), ("embed", "vocab"))
    if cfg.encoder_layers:
        enc = dataclasses.replace(cfg, qkv_bias=False,
                                  num_layers=cfg.encoder_layers)
        t["encoder"] = {
            "blocks": _stack(_layer_templates(enc, ATTN, MLP),
                             cfg.encoder_layers),
            "final_norm": ParamTemplate((d,), ("embed",), init="ones"),
        }
    return t


def _leaves(tree: Any, prefix: str = ""):
    """(path, leaf) pairs in sorted-key order — the order jax flattens a
    dict tree in."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = "cuda",
                dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Random parameters from a seeded generator on ``device``.

    Normal leaves are drawn in float32 and cast to ``dtype`` (default
    ``cfg.dtype``), one leaf at a time so the float32 temporary is never
    larger than the largest leaf.
    """
    dev = resolve_device(device)
    dt = dtype or getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def mk(t: ParamTemplate) -> torch.Tensor:
        if t.init == "zeros":
            return torch.zeros(t.shape, dtype=dt, device=dev)
        if t.init == "ones":
            return torch.ones(t.shape, dtype=dt, device=dev)
        if t.init == "ssm_a":          # A in [1, 16), stored as log
            u = torch.empty(t.shape, dtype=torch.float32, device=dev)
            return u.uniform_(1.0, 16.0, generator=gen).log_().to(dt)
        if t.init == "ssm_dt":         # dt bias = softplus^-1(U[1e-3, 1e-1])
            u = torch.empty(t.shape, dtype=torch.float32, device=dev)
            return u.uniform_(1e-3, 1e-1, generator=gen).expm1_().log_().to(dt)
        w = torch.randn(t.shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return w.mul_(t.scale).to(dt)

    templates = param_templates(cfg)
    made = {path: mk(t) for path, t in _leaves(templates)}

    def build(tree: Any, prefix: str = "") -> Any:
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in tree.items()}
        return made[prefix[:-1]]
    return build(templates)


def _to_torch(arr: Any, dev: torch.device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:       # views of jax buffers are read-only
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 is unknown to torch.from_numpy: move the raw
        # 16-bit words and reinterpret them, never upcasting
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def params_from_numpy(tree: Any, device: DeviceLike = "cuda") -> Any:
    """A nested dict of numpy arrays (e.g. the JAX package's params passed
    through ``np.asarray``) as torch tensors of the same dtype and
    layout."""
    dev = resolve_device(device)
    return _map(lambda a: _to_torch(a, dev), tree)
