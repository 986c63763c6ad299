"""Roofline terms of one dry-run step (the port of
``repro/launch/roofline.py``).

Three terms per (arch x shape x mesh), in seconds per step of one
rank's program, on the H100's constants (``parallel.mesh``):

  compute    = FLOPs per rank / peak bf16 FLOP/s
  memory     = HBM bytes per rank / HBM bandwidth
  collective = collective bytes per rank / NVLink bandwidth

FLOPs and HBM bytes come from the analytic cost model
(``launch.costmodel``). The JAX package reads its collective bytes out
of the compiled HLO (``parse_collectives_loop_aware``,
``parse_collective_bytes``, ``entry_io_bytes``, and
``normalize_cost_analysis`` for XLA's cost analysis); torch compiles no
HLO, so those parsers have no input and are not ported. The port counts
the bytes of the collectives its step issues instead
(``parallel.collectives.COLLECTIVE_BYTES``).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.launch.costmodel import reference_param_count
from repro_torch.parallel.mesh import HBM_BW, ICI_BW, PEAK_BF16_FLOPS


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Ideal algorithmic FLOPs per step, global: 6 N D (train, fwd+bwd) or
    2 N D (inference fwd), N = the *active* params (the JAX package's
    count)."""
    n_active = reference_param_count(cfg, active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch                # one token per sequence
    return 2.0 * n_active * tokens


def roofline(flops_per_dev: float, bytes_per_dev: float,
             coll_bytes_per_dev: float) -> Dict[str, float]:
    t_c = flops_per_dev / PEAK_BF16_FLOPS
    t_m = bytes_per_dev / HBM_BW
    t_n = coll_bytes_per_dev / ICI_BW
    dom = max((t_c, "compute"), (t_m, "memory"), (t_n, "collective"))
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_n,
            "bottleneck": dom[1]}


def fmt_row(name: str, terms: Dict[str, float]) -> str:
    return (f"{name:55s} comp={terms['compute_s']*1e3:9.3f}ms "
            f"mem={terms['memory_s']*1e3:9.3f}ms "
            f"coll={terms['collective_s']*1e3:9.3f}ms "
            f"-> {terms['bottleneck']}")


__all__ = ["model_flops", "roofline", "fmt_row"]
