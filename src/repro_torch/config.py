"""Configuration dataclasses for the PyTorch port.

The port's own copy of the model, policy-optimization, training and
serving configuration (``repro/config.py`` in the JAX package).
``ModelConfig``, ``RLConfig`` and ``TrainConfig`` keep the same fields
and defaults, so a config built here describes the same model and update
as its JAX namesake; only the ``paged_attn_impl`` default differs (see
below). ``HeteroConfig`` keeps the JAX package's fields and defaults
too. ``ServeConfig`` holds the deployment fields the serving path uses.
Both take a ``DxM`` (or ``PxDxM``) mesh, ``sampler_mesh`` and ``mesh``:
both engines and the front door serve on it (the continuous engine
tensor-parallel, the static engine with a context-parallel decode),
whatever the mesh's cut of the heads.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Layer kinds usable in ``block_pattern``.
ATTN = "attn"          # global causal self-attention
LOCAL = "local"        # sliding-window causal self-attention
MAMBA = "mamba"        # Mamba2 / SSD block (attention-free)
CROSS = "cross"        # cross-attention to a stub modality memory (VLM)

# FFN kinds usable in ``ffn_pattern``.
MLP = "mlp"
MOE = "moe"
NONE = "none"          # e.g. Mamba2 blocks carry no separate FFN

PAGED_IMPLS = ("auto", "pallas", "ref", "gather")
SSD_IMPLS = ("chunked", "pallas")
LOGPROB_IMPLS = ("fused", "pallas", "chunked", "naive")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # layer layout -------------------------------------------------------
    block_pattern: Tuple[str, ...] = (ATTN,)
    ffn_pattern: Tuple[str, ...] = (MLP,)

    # attention options ---------------------------------------------------
    qkv_bias: bool = False
    sliding_window: int = 4096      # used by LOCAL layers
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_theta: float = 1_000_000.0

    # MoE options ---------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # expert-parallel MoE ("train" | "serve"; None = the dispatch of
    # models/moe.py): experts split over the mesh's 'model' axis
    # (models/moe_ep.py), which the sharded step registers
    # (runtime_context); ep_dp_axes = the data axes of the mesh
    moe_ep: Optional[str] = None
    ep_dp_axes: Optional[Tuple[str, ...]] = None

    # SSM (Mamba2 / SSD) options -----------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # encoder / multimodal stubs -----------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0
    memory_seq: int = 0

    # numerics ------------------------------------------------------------
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    scale_embed: bool = False       # multiply embeddings by sqrt(d) (gemma)

    # residual-stream sharding and head-sharded q/k/v of the JAX
    # package's tensor-parallel layout (set by a launcher from
    # parallel.axes.act_sharding_for). Accepted and recorded: the port's
    # sharded step computes each rank's rows with whole weights, so they
    # change no number (ROADMAP queue 3)
    act_sharding: Optional[Tuple] = None
    attn_gather_qkv: bool = False

    # implementation knobs (not architecture) -----------------------------
    attn_impl: str = "chunked"      # naive | chunked | pallas
    attn_chunk: int = 512
    # Paged-attention backend of the continuous engine
    # (repro_torch.kernels.ops): "pallas" = the hand-written Hopper
    # kernel, "ref" = its plain PyTorch twin, "auto" = kernel for CUDA
    # tensors and twin for CPU tensors. The JAX package defaults to
    # "gather" to keep its static and continuous engines bit-identical;
    # the port holds its two engines to each other within a tolerance
    # instead, and "auto" sends the serving path through the kernels.
    # "gather" materialises each slot's logical KV view and runs the
    # dense attention over it (plain PyTorch, any device).
    paged_attn_impl: str = "auto"
    remat: bool = True
    # ring-buffer the dense KV cache of LOCAL layers (window rows, not
    # the whole prompt + budget); the paged engine refuses it
    local_ring_kv: bool = False
    # SSD backend of the Mamba2 blocks (a knob of the port only; the JAX
    # package always runs its chunked SSD). "chunked" = the plain
    # PyTorch chunked SSD, the JAX package's own path. "pallas" = the
    # SSD chunk-scan kernel K6 (kernels/ops.py::ssd_scan) wherever a
    # forward has no cache and no autograd recording (the App. B.1
    # recompute); a forward that fills a cache keeps the chunked path,
    # which also returns the final state, and a forward under autograd
    # raises (K6 has no backward). It changes the route, not the function
    # (K6 writes y in x's dtype: one bf16 rounding more in a bf16 model).
    ssd_impl: str = "chunked"

    # ---------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        period = len(self.block_pattern)
        if self.num_layers % period:
            raise ValueError(f"{self.name}: num_layers={self.num_layers} not "
                             f"divisible by pattern period {period}")
        if self.paged_attn_impl not in PAGED_IMPLS:
            raise ValueError(f"unknown paged_attn_impl "
                             f"{self.paged_attn_impl!r}; have {PAGED_IMPLS}")
        if self.ssd_impl not in SSD_IMPLS:
            raise ValueError(f"unknown ssd_impl {self.ssd_impl!r}; have "
                             f"{SSD_IMPLS}")
        if self.moe_ep not in (None, "train", "serve"):
            raise ValueError(f"moe_ep={self.moe_ep!r} not train|serve|None")

    # derived -------------------------------------------------------------
    @property
    def period(self) -> int:
        return len(self.block_pattern)

    @property
    def num_blocks(self) -> int:
        """Number of stacked super-blocks (one pattern period each)."""
        return self.num_layers // self.period

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (151936 -> 152064)."""
        return _round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    def ffn_kind(self, layer_in_block: int) -> str:
        return self.ffn_pattern[layer_in_block % len(self.ffn_pattern)]

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self, active_only: bool = False) -> int:
        """Parameter count: embedding, untied head, per layer its mixer
        (attention, cross-attention or Mamba2) and FFN (MLP, MoE with its
        router and shared expert, or none) and two norms, and the encoder
        of an encoder-decoder model, as the JAX package counts them; plus
        what the JAX count leaves out: the final norm, the QKV biases, and
        in an encoder-decoder model the decoder's cross-attention and its
        norm in every layer and the encoder's final norm. ``active_only``
        counts the ``experts_per_token`` experts a token runs of a MoE
        layer's ``num_experts``. (The cost model keeps the JAX package's
        own count: ``launch.costmodel.reference_param_count``.)"""
        d, h = self.d_model, self.head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        attn = d * (n_q * h) + 2 * d * (n_kv * h) + (n_q * h) * d
        total = self.padded_vocab * d
        if not self.tie_embeddings:
            total += self.padded_vocab * d
        for li in range(self.num_layers):
            kind = self.block_pattern[li % self.period]
            if kind in (ATTN, LOCAL, CROSS):
                total += attn
                if self.qkv_bias and kind != CROSS:
                    total += (n_q + 2 * n_kv) * h
                if self.is_encdec:                # the decoder's cross
                    total += attn + d
            elif kind == MAMBA:
                di, n, g = self.d_inner, self.ssm_state, self.ssm_ngroups
                total += d * (2 * di + 2 * g * n + self.ssm_heads)  # in_proj
                total += di * d                                      # out_proj
                total += self.ssm_conv * (di + 2 * g * n)            # conv
            fk = self.ffn_kind(li % self.period)
            if fk == MLP:
                total += 3 * d * self.d_ff
            elif fk == MOE:
                n_e = (self.experts_per_token if active_only
                       else self.num_experts)
                total += 3 * d * self.d_ff * n_e
                total += d * self.num_experts                        # router
                if self.shared_expert:
                    total += 3 * d * self.d_ff
            total += 2 * d                                            # norms
        if self.encoder_layers:
            # the JAX count takes 4 d (n_q h) for the attention, as if
            # n_kv == n_q (true of whisper-small)
            total += self.encoder_layers * (attn + 3 * d * self.d_ff + 2 * d)
            total += d                                    # its final norm
        return total + d


@dataclass(frozen=True)
class ShapeConfig:
    """One of the dry-run's input shapes (the JAX package's)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")
INPUT_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in INPUT_SHAPES}


@dataclass(frozen=True)
class RLConfig:
    """Policy-optimization settings (paper §3/§4 + App. B): the loss
    (``loss_type``, clipping, KL, advantages, ``gepo_smooth``) read by
    ``repro_torch.training``, and the sampling profile and
    ``max_new_tokens`` read by the engines."""
    loss_type: str = "gepo"
    group_size: int = 8
    clip_eps: float = 0.2
    cispo_eps_low: float = 1.0
    cispo_eps_high: float = 0.27
    beta_kl: float = 0.005
    adv_normalize: bool = True
    seq_len_normalize: bool = True
    gepo_smooth: float = 0.0
    temperature: float = 0.6
    top_k: int = 20
    top_p: float = 0.95
    max_new_tokens: int = 32
    recompute_sampler_logps: bool = True
    entropy_bonus: float = 0.0
    engine: str = "static"


@dataclass(frozen=True)
class TrainConfig:
    """Learner settings: AdamW/Adafactor hyper-parameters, the warm-up
    schedule, gradient clipping and accumulation, and the token log-prob
    backend of the loss."""
    learning_rate: float = 1e-6
    warmup_frac: float = 0.03
    total_steps: int = 1000
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    grad_accum: int = 1
    seed: int = 0
    # Learner rank mesh as "DxM" (data x model; "PxDxM" adds the slow
    # inter-pod axis). "1x1" = one device, no process group. Resolved by
    # the execution layer (repro_torch.parallel.plan_from_flag) when a
    # plan is built: a larger mesh runs under torchrun, one rank a
    # process, and raises when the process group is smaller.
    mesh: str = "1x1"
    # Token log-prob backend of the loss (repro_torch.kernels.ops):
    #   "fused"   -- the K1/K2 kernels on CUDA tensors, the twin on CPU;
    #   "pallas"  -- the kernels, raising on CPU tensors;
    #   "chunked" -- the plain PyTorch twin on any device;
    #   "naive"   -- the materializing log-softmax (repro_torch.core.logprob).
    logprob_impl: str = "fused"

    def __post_init__(self):
        if self.logprob_impl not in LOGPROB_IMPLS:
            raise ValueError(f"unknown logprob_impl {self.logprob_impl!r}; "
                             f"have {LOGPROB_IMPLS}")
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {self.grad_accum}")


def _check_mesh(field: str, spec: str) -> None:
    """``ValueError`` unless ``spec`` is a ``DxM`` (or ``PxDxM``) mesh."""
    from repro_torch.parallel.mesh import parse_mesh
    try:
        parse_mesh(spec)
    except ValueError as e:
        raise ValueError(f"{field}: {e}") from None


@dataclass(frozen=True)
class HeteroConfig:
    """HeteroRL runtime settings (paper §4.1 + App. E), the JAX package's
    fields and defaults."""
    num_samplers: int = 4
    max_delay_steps: int = 64        # staleness window in learner steps
    delay_distribution: str = "lognormal"   # lognormal | weibull | exponential
    delay_min_s: float = 60.0
    delay_max_s: float = 1800.0
    delay_median_s: float = 60.0
    sync_interval_steps: int = 1     # learner checkpoint publish period
    window_s: float = 1800.0         # rollout eligibility window
    seed: int = 0
    # Simulated WAN bandwidth of the model-sync link (Mbit/s). inf keeps
    # the payload-blind delay model; a finite value adds
    # payload_bytes/bandwidth serialization time to the sampled
    # propagation delay (hetero.latency.sync_delay_s).
    bandwidth_mbps: float = float("inf")
    # Sampler-node mesh "DxM" (a serve-mode ExecutionPlan; more than one
    # rank runs under torchrun).
    sampler_mesh: str = "1x1"
    # Sampler-side paged-attention backend (ModelConfig.paged_attn_impl
    # vocabulary; None keeps the arch's).
    paged_attn_impl: Optional[str] = None
    # Sampler-side speculative decoding draft cap; 0 = off.
    spec_k: int = 0

    def __post_init__(self):
        _check_mesh("HeteroConfig.sampler_mesh", self.sampler_mesh)
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {self.spec_k}")


@dataclass(frozen=True)
class ServeConfig:
    """Deployment settings for a generation engine and its serving front
    door: engine kind, KV capacity, decode horizon, speculative drafting,
    admission limits, and the serve mesh ``DxM`` (the JAX package's
    ``ServeConfig``). The same object configures batch serving
    (``launch/serve.py``), the asyncio front door
    (``repro_torch.serving.server``) and HeteroRL sampler nodes."""
    engine: str = "continuous"       # static | continuous
    num_slots: int = 8
    page_size: int = 16
    prefill_chunk: int = 0           # prompt tokens per chunk (0 = whole)
    sync_every: int = 8
    max_total_tokens: int = 256
    num_pages: int = 0               # 0 = derive from slots x budget
    prefix_cache: bool = True
    prefix_cache_entries: int = 64
    paged_attn_impl: Optional[str] = None   # ModelConfig override (None=keep)
    # speculative decoding (continuous engine only): drafts per verify
    # round (0 = off). Acceptance replays the engine's own draws, so the
    # emitted tokens are the non-speculative engine's.
    spec_k: int = 0
    spec_ngram_max: int = 3          # prompt-lookup suffix n-gram (longest)
    spec_ngram_min: int = 1          # ... shortest suffix tried
    # replay each verify round's attention through one folded K4 launch
    # and keep max |folded - in-forward| (stats()["spec_rescore_max_diff"])
    spec_rescore: bool = True
    # front door -----------------------------------------------------------
    host: str = "127.0.0.1"
    port: int = 8100
    max_queue: int = 256             # admission: queued-request cap
    # admission: shed load once the KV pages promised to queued requests
    # exceed this many turns of the page pool (1.0 = the queue may never
    # hold more demand than the pool serves in one full drain)
    queue_overcommit: float = 4.0
    default_priority: int = 1        # priority class for unlabelled requests
    default_deadline_s: float = 0.0  # TTFT SLO applied when none given (0=off)
    seed: int = 0
    mesh: str = "1x1"                # serve mesh DxM (TrainConfig.mesh conv.)

    def __post_init__(self):
        _check_mesh("ServeConfig.mesh", self.mesh)
        if self.engine not in ("static", "continuous"):
            raise ValueError(f"engine={self.engine!r} not static|continuous")
        if self.num_slots < 1 or self.page_size < 1 or self.sync_every < 1:
            raise ValueError("num_slots, page_size, sync_every must be >= 1")
        if self.max_total_tokens < 2:
            raise ValueError("max_total_tokens must hold a prompt token "
                             "and a completion token at least")
        if self.prefill_chunk < 0 or self.num_pages < 0:
            raise ValueError("prefill_chunk / num_pages must be >= 0")
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if self.queue_overcommit < 1.0:
            raise ValueError("queue_overcommit < 1 would reject requests "
                             "an idle pool could serve")
        if self.spec_k < 0:
            raise ValueError("spec_k must be >= 0 (0 = speculation off)")
        if self.spec_k > 0 and self.engine != "continuous":
            raise ValueError("speculative decoding (spec_k > 0) needs the "
                             "continuous engine")
        if not 1 <= self.spec_ngram_min <= self.spec_ngram_max:
            raise ValueError("need 1 <= spec_ngram_min <= spec_ngram_max")

    @property
    def pages_per_slot(self) -> int:
        return -(-self.max_total_tokens // self.page_size)

    @property
    def resolved_num_pages(self) -> int:
        """Explicit ``num_pages``, or scratch + the full budget of every
        slot, plus 50% headroom when the prefix cache is on."""
        if self.num_pages:
            return self.num_pages
        base = self.num_slots * self.pages_per_slot
        headroom = base // 2 if self.prefix_cache else 0
        return 1 + base + headroom


def smoke_variant(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A reduced same-family variant for CPU smoke tests: <=2 pattern
    periods of layers, d_model <= 256, f32."""
    period = cfg.period
    small = dict(
        num_layers=2 * period if 2 * period <= 4 else period,
        d_model=256 if cfg.d_model >= 256 else cfg.d_model,
        num_heads=min(cfg.num_heads, 4) if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=64 if cfg.num_heads else 0,
        d_ff=512 if cfg.d_ff else 0,
        vocab_size=512,
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=32 if cfg.encoder_seq else 0,
        memory_seq=16 if cfg.memory_seq else 0,
        ssm_state=min(cfg.ssm_state, 32) if cfg.ssm_state else 0,
        ssm_headdim=32 if cfg.ssm_state else cfg.ssm_headdim,
        ssm_chunk=16 if cfg.ssm_state else cfg.ssm_chunk,
        sliding_window=min(cfg.sliding_window, 64),
        attn_impl="naive",
        attn_chunk=32,
        dtype="float32",
        remat=False,
        name=cfg.name + "-smoke",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
