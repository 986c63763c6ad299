"""Learner and Sampler nodes of the HeteroRL star topology (§4.1, Fig. 3):
the port of ``repro/hetero/nodes.py``.

- Sampler nodes continuously generate rollout groups with their (stale)
  policy copy, score them locally (App. F localized rewards — group
  statistics never cross the network), and stream version-stamped batches
  to the learner.
- The learner consumes batches in arrival order inside a fixed
  time-window / staleness-window, updates parameters, and periodically
  publishes checkpoints to the ``PolicyStore``; samplers pull the latest
  version only after their simulated WAN delay D_M.

The port's optimizer updates the learner's tensors in place (the JAX step
donates them), so every node owns its own copy of the weights: the
learner clones the caller's state, and a sampler's params never share
storage with the learner's. A sampler that aliased them would serve the
newest weights under an old version stamp, and staleness would be a
fiction. A node runs on ``device`` (default ``cuda``); on a CUDA device
the engines and the learner step launch the kernels or raise. The
learner runs on an ``ExecutionPlan`` (``plan=``, default the
``TrainConfig.mesh`` knob; ``device=`` is the shorthand for the local
plan on that device): on a live mesh it keeps its state sharded, and
samplers and evals take its ``full_params()``. A sampler runs on a
``serve`` plan (``plan=``, default the ``HeteroConfig.sampler_mesh``
knob): on a live one it keeps its shard of the weights, serves through
either engine (``rl.engine``: the continuous engine tensor-parallel, the
static engine with a context-parallel decode, which also serves the SSM
and memory families), and fetches only its rank's cells of each
published version (``ChunkSubscriber.sync(rank=)``); ``sync(plan=)``
re-fits it onto another plan.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import PolicyStore
from repro_torch.config import (HeteroConfig, ModelConfig, RLConfig,
                                ServeConfig, TrainConfig)
from repro_torch.core.diagnostics import MetricsHistory
from repro_torch.data import (ArithmeticTask, PromptPipeline, Tokenizer,
                              score_rollouts)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.hetero.latency import sync_delay_s
from repro_torch.optim import tree_leaves
from repro_torch.sampling import (ContinuousEngine, build_engine,
                                  rollout_from_results, token_logps)
from repro_torch.sampling.prng import PRNGKey, split
from repro_torch.serving.api import Request, SamplingParams
from repro_torch.parallel import ExecutionPlan, plan_from_flag
from repro_torch.training import TrainState, jit_train_step
from repro_torch.transport import (ChunkSubscriber, SimulatedLink,
                                   publish_params)


def copy_tree(tree: Any, device: torch.device) -> Any:
    """A detached copy of a tree of tensors (dicts and (named) tuples) on
    ``device``, sharing no storage with ``tree``."""
    if isinstance(tree, dict):
        return {k: copy_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [copy_tree(v, device) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            tuple(items)
    return tree.detach().to(device, copy=True)


@torch.no_grad()
def copy_into(dst: Any, src: Any) -> None:
    """Copy every leaf of ``src`` into the matching leaf of ``dst``, in
    place (across devices)."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src), strict=True):
        d.copy_(s)


@dataclasses.dataclass
class RolloutBatch:
    tokens: np.ndarray          # (B, T)
    mask: np.ndarray            # (B, T-1) target-position mask
    sampler_lp: np.ndarray      # (B, T-1)
    rewards: np.ndarray         # (B,) group-contiguous
    version: int                # policy version that generated it
    created_s: float
    sampler_id: int

    def nbytes(self) -> int:
        return (self.tokens.nbytes + self.mask.nbytes
                + self.sampler_lp.nbytes + self.rewards.nbytes)


class SamplerNode:
    """Generates rollouts with a possibly-stale policy copy."""

    def __init__(self, sid: int, cfg: ModelConfig, rl: RLConfig,
                 pipeline: PromptPipeline, task: ArithmeticTask,
                 tok: Tokenizer, params: Any, store: PolicyStore,
                 hcfg: HeteroConfig, seed: int,
                 logprob_impl: str = "fused",
                 device: DeviceLike = "cuda",
                 plan: Optional[ExecutionPlan] = None) -> None:
        self.sid = sid
        # sampler-side paged-attention backend (the HeteroConfig knob
        # beats the arch default)
        if hcfg.paged_attn_impl is not None:
            cfg = dataclasses.replace(cfg,
                                      paged_attn_impl=hcfg.paged_attn_impl)
        self.cfg, self.rl = cfg, rl
        # sampler-side speculative decoding (continuous engine only)
        self.spec_k = hcfg.spec_k
        self.pipeline, self.task, self.tok = pipeline, task, tok
        # serve-mode execution plan of this node: the sampler_mesh knob by
        # default (the local plan on ``device`` for 1x1)
        self.plan = plan or plan_from_flag(hcfg.sampler_mesh, "serve",
                                           resolve_device(device))
        self.device = self.plan.device or resolve_device(device)
        # the node's own copy (its shard on a live plan): never an alias
        # of the learner's tensors, which its optimizer overwrites in place
        self.params = self.plan.device_put_params(cfg, params, copy=True)
        self.store = store
        self.hcfg = hcfg
        # chunked checkpoint client: chunk cache + WAN link of this node
        # (repro_torch.transport) — syncs move only the chunks whose
        # content changed since the last sync
        self.link = SimulatedLink(bandwidth_mbps=hcfg.bandwidth_mbps)
        self.subscriber = ChunkSubscriber(store, self.link)
        # one engine per node (``rl.engine``), built at the first batch:
        # its KV budget needs the prompt width
        self._gen_engine = None
        self._engine_tp = -1
        # backend of the App. B.1 recompute — follows the learner's
        # TrainConfig.logprob_impl so A/B runs switch both halves
        self.logprob_impl = logprob_impl
        self.version = 0
        self.rng = np.random.default_rng(seed)
        # the draw key: split once per batch, as the reference does
        self.key = PRNGKey(seed)
        # the repo's RA005 analysis holds every SamplerNode to the
        # reference's threading contract (its threaded runtime hands nodes
        # to threading.Thread): each mutation of the node's state is taken
        # under this lock
        self._lock = threading.Lock()
        self.batches_generated = 0
        self.syncs = 0
        # operator telemetry: generation rate of this node. The first
        # batch pays the engine's first launches (the kernels' first use
        # on a card); it is accounted separately (warmup_*) so
        # tokens_per_s reports the steady-state rate.
        self.tokens_generated = 0
        self.gen_seconds = 0.0
        self.warmup_tokens = 0
        self.warmup_seconds = 0.0
        self.engine_stats: Dict[str, float] = {}
        # unified observability: this node's trace track + per-sampler
        # metric handles
        self._track = f"sampler-{sid}"
        m = obs.metrics
        self._m_batches = m.counter(
            "sampler_batches_total", "rollout batches generated",
            sampler=sid)
        self._m_gen_tokens = m.counter(
            "sampler_gen_tokens_total", "completion tokens generated",
            sampler=sid)
        self._m_syncs = m.counter(
            "sampler_syncs_total", "weight syncs applied", sampler=sid)
        self._m_sync_bytes = m.counter(
            "sampler_sync_bytes_total", "weight-sync bytes on the wire",
            sampler=sid)
        self._g_version = m.gauge(
            "sampler_policy_version", "policy version this node holds",
            sampler=sid)
        # speculative decoding: the engine's cumulative accept rate and
        # the drafts it proposed (set when spec_k > 0)
        self._g_accept = m.gauge(
            "sampler_accept_rate",
            "speculative-decode draft acceptance rate of this node",
            sampler=sid)
        self._m_drafted = m.counter(
            "sampler_drafted_tokens_total",
            "draft tokens proposed by this node's engine", sampler=sid)
        self._drafted_seen = 0   # engine stats are cumulative; the counter
        #                          takes the increments

    @property
    def tokens_per_s(self) -> float:
        """Steady-state generation rate (first batch excluded); falls back
        to the warmup-inclusive rate until a second batch has been
        generated."""
        if self.gen_seconds:
            return self.tokens_generated / self.gen_seconds
        if self.warmup_seconds:
            return self.warmup_tokens / self.warmup_seconds
        return 0.0

    def _engine_for(self, tp: int, b: int):
        """The node's engine, built on first use (the paged pool's budget
        needs the prompt width). Rebuilt only if the rollout shape
        changes."""
        with self._lock:
            if self._gen_engine is None or self._engine_tp != tp:
                serve = ServeConfig(
                    engine=self.rl.engine,
                    max_total_tokens=tp + self.rl.max_new_tokens,
                    num_slots=min(b, 8), spec_k=self.spec_k)
                self._gen_engine = build_engine(
                    self.cfg, self.params, serve, rl=self.rl,
                    vocab_limit=self.tok.vocab_size, plan=self.plan)
                self._engine_tp = tp
            return self._gen_engine

    def generate_batch(self, now_s: float) -> RolloutBatch:
        req = self.pipeline.next_batch()
        prompts_np = np.asarray(req.prompts)
        b, tp = prompts_np.shape
        engine = self._engine_for(tp, b)
        with self._lock:
            self.key, k = split(self.key)
        t0 = time.perf_counter()
        # rid = batch row, a fresh key per batch
        sp = SamplingParams.from_rl(self.rl)
        with obs.trace.span("sampler_generate", track=self._track,
                            sampler=self.sid, version=self.version,
                            batch=b):
            results = engine.generate(
                [Request(rid=r, prompt=prompts_np[r], params=sp)
                 for r in range(b)], key=k)
        roll = rollout_from_results(prompts_np, results,
                                    self.rl.max_new_tokens,
                                    device=self.device)
        comp_mask = roll["comp_mask"].cpu().numpy()
        ntok = int(comp_mask.sum())
        dt = time.perf_counter() - t0
        with self._lock:
            if self.batches_generated == 0:     # first launches folded in
                self.warmup_tokens += ntok
                self.warmup_seconds += dt
            else:
                self.tokens_generated += ntok
                self.gen_seconds += dt
            if isinstance(engine, ContinuousEngine):
                self.engine_stats = dict(engine.stats())
            if self.spec_k > 0 and self.engine_stats:
                self._g_accept.set(self.engine_stats["accept_rate"])
                drafted = int(self.engine_stats["drafted_tokens_total"])
                self._m_drafted.inc(drafted - self._drafted_seen)
                self._drafted_seen = drafted
        rewards = score_rollouts(self.task, self.tok, req.problems,
                                 roll["completions"].cpu().numpy(),
                                 req.group_size)
        if self.rl.recompute_sampler_logps:
            # App. B.1: engine logps are untrusted; do a dedicated
            # forward pass under the *sampler's own* parameters.
            lp = token_logps(self.cfg, self.params, roll["tokens"],
                             logprob_impl=self.logprob_impl, plan=self.plan)
            comp_lp = lp[:, tp - 1:]
        else:
            comp_lp = roll["sampler_lp"]
        zeros = np.zeros((b, tp - 1), np.float32)
        mask = np.concatenate([zeros, comp_mask], axis=1)
        sampler_lp = np.concatenate([zeros, comp_lp.cpu().numpy()], axis=1)
        with self._lock:
            self.batches_generated += 1
        self._m_batches.inc()
        self._m_gen_tokens.inc(ntok)
        return RolloutBatch(tokens=roll["tokens"].cpu().numpy(), mask=mask,
                            sampler_lp=sampler_lp, rewards=rewards,
                            version=self.version, created_s=now_s,
                            sampler_id=self.sid)

    def sync(self, plan: Optional[ExecutionPlan] = None) -> int:
        """Fetch the newest published checkpoint through the chunk
        transport (delta-synced against this node's local cache) and copy
        it into this node's params on its device (a rank of a live plan
        fetches and copies its own shards). Returns the simulated bytes
        that moved on the wire (manifest + missing chunks), which feeds
        the payload-aware delay of the *next* sync.

        ``plan`` re-fits the node onto another plan: the newest version,
        or the weights it holds when nothing newer is published, placed
        on the new plan's grid, the engine rebuilt at the next batch (its
        pools are the old plan's). The plan is committed only after the
        fetch succeeds."""
        refit = plan is not None and plan != self.plan
        latest = self.store.latest_version()
        if latest < 0 or (latest <= self.version and not refit):
            if refit:           # nothing newer: re-place the live weights
                full = self.plan.gather_params(self.cfg, self.params)
                with self._lock:
                    self._refit_locked(plan, plan.device_put_params(
                        self.cfg, full, copy=True))
            return 0
        target = plan if refit else self.plan
        rank = target.mesh.rank if target.mesh.live else None
        for attempt in range(3):
            try:
                with obs.trace.span("weight_sync", track=self._track,
                                    sampler=self.sid, refit=refit):
                    v, host_tree, stats = self.subscriber.sync(
                        self.params, cfg=self.cfg, plan=target, rank=rank)
                break
            except KeyError:
                # threaded runtime: a publisher on another thread pruned
                # the fetched manifest's chunks between fetch and
                # assembly; retry against the newest version, three times
                if attempt == 2:
                    raise
        newer = v > self.version
        if refit:
            with self._lock:
                self._refit_locked(
                    target, target.device_put_params(self.cfg, host_tree))
                self.version = v
        else:
            self.load_params(host_tree, v)
        with self._lock:
            self.syncs += int(newer)
        self._m_syncs.inc()
        self._m_sync_bytes.inc(stats.bytes_on_wire)
        self._g_version.set(self.version)
        return stats.bytes_on_wire

    def load_params(self, tree: Any, version: int) -> None:
        """Copy ``tree`` (full leaves, or this rank's shards) into this
        node's own tensors and stamp it ``version``. The engine is told of
        the change, so it drops KV it computed under the old weights (its
        prefix cache)."""
        with self._lock:
            copy_into(self.params, self.plan.local_shards(self.cfg, tree))
            if self._gen_engine is not None:
                self._gen_engine.update_params(self.params)
            self.version = version

    def _refit_locked(self, plan: ExecutionPlan, params: Any) -> None:
        """Commit ``plan`` and the params placed on it (caller holds
        ``self._lock``)."""
        self.plan, self.params = plan, params
        self.device = plan.device or self.device
        self._gen_engine = None

    def next_delay(self, payload_bytes: int = 0) -> float:
        return sync_delay_s(self.rng, self.hcfg, payload_bytes)

    def link_stats(self) -> Dict[str, float]:
        """Per-node link telemetry: bytes on wire, dedup ratio (needed
        refs served from cache), simulated serialization seconds."""
        sub = self.subscriber
        total = sub.chunks_fetched + sub.chunk_hits
        row = {"sampler": float(self.sid), "syncs": float(self.syncs),
               "bytes_on_wire": float(self.link.bytes_on_wire),
               "sync_seconds": float(self.link.seconds),
               "chunks_fetched": float(sub.chunks_fetched),
               "chunk_hits": float(sub.chunk_hits),
               "dedup_ratio": sub.chunk_hits / total if total else 0.0}
        # thin view over the registry: the same row lands as per-sampler
        # link_* gauges so the exporters and sync_telemetry never disagree
        if obs.metrics.enabled:
            obs.metrics.set_many(
                "link", {k: v for k, v in row.items() if k != "sampler"},
                sampler=self.sid)
        return row


def link_telemetry(samplers: List[SamplerNode],
                   learner: LearnerNode) -> List[Dict[str, float]]:
    """Per-sampler weight-transport telemetry (bytes on wire, dedup
    ratio, simulated sync seconds) plus the learner's publish-side stream
    accounting as a pseudo-row (sampler=-1)."""
    rows = [s.link_stats() for s in samplers]
    rows.append({"sampler": -1.0,
                 "syncs": float(learner.step),
                 "bytes_on_wire": float(learner.bytes_streamed),
                 "sync_seconds": 0.0,
                 "chunks_fetched": float(learner.chunks_streamed),
                 "chunk_hits": 0.0, "dedup_ratio": 0.0})
    return rows


class LearnerNode:
    """Consumes rollout batches in arrival order within the staleness
    window; publishes checkpoints."""

    def __init__(self, cfg: ModelConfig, rl: RLConfig, tc: TrainConfig,
                 hcfg: HeteroConfig, state: TrainState,
                 store: PolicyStore, device: DeviceLike = "cuda",
                 plan: Optional[ExecutionPlan] = None) -> None:
        self.cfg, self.rl, self.tc, self.hcfg = cfg, rl, tc, hcfg
        self.device = resolve_device(device)
        # learner execution plan: the TrainConfig.mesh knob by default
        # (the local plan on ``device`` for 1x1). The step updates its
        # state in place, so the node takes a plan-placed copy: the
        # caller's state (often a warm start shared across runs) stays as
        # it was
        self.plan = plan or plan_from_flag(tc.mesh, "train", self.device)
        self.state = self.plan.device_put_state(cfg, state, "adamw",
                                                copy=True)
        self.step_fn = jit_train_step(cfg, rl, tc, plan=self.plan)
        self.store = store
        self.buffer: List[Tuple[float, RolloutBatch]] = []
        self.step = 0
        self.discarded = 0
        self.history = MetricsHistory()
        # cumulative publish telemetry (net-new bytes/chunks streamed)
        self.bytes_streamed = 0
        self.chunks_streamed = 0
        self.publish_stats = None
        self._publish()

    def _publish(self) -> None:
        """Stream this step's params into the store as content-addressed
        chunks (repro_torch.transport) plus the version manifest.
        Unchanged chunks cost nothing."""
        self.publish_stats = publish_params(
            self.store, self.step, self.plan, self.cfg, self.state.params)
        self.bytes_streamed += self.publish_stats.bytes_new
        self.chunks_streamed += self.publish_stats.chunks_new

    def full_params(self) -> Any:
        """The learner's params as full leaves on its device: the state's
        own tensors on a local plan, a gather (every rank together) on a
        live one. Samplers and evals take these."""
        return self.plan.gather_params(self.cfg, self.state.params)

    def receive(self, now_s: float, batch: RolloutBatch) -> None:
        self.buffer.append((now_s, batch))

    def pop_eligible(self, now_s: float) -> Optional[RolloutBatch]:
        """Oldest-arrival batch satisfying window + staleness limits."""
        while self.buffer:
            arrival, batch = self.buffer[0]
            window_ok = (now_s - batch.created_s) <= self.hcfg.window_s
            stale_ok = (self.step - batch.version) <= self.hcfg.max_delay_steps
            if window_ok and stale_ok:
                self.buffer.pop(0)
                return batch
            self.buffer.pop(0)
            self.discarded += 1
        return None

    def train_on(self, batch: RolloutBatch) -> Dict[str, float]:
        with obs.trace.span("learner_step", track="learner",
                            step=self.step, version=batch.version,
                            sampler=batch.sampler_id):
            dev = self.plan.device or self.device
            # the batch arrives on the host: one copy in per step
            tb = {k: torch.from_numpy(getattr(batch, k)).to(dev)  # noqa: RA003 — batch in
                  for k in ("tokens", "mask", "sampler_lp", "rewards")}
            self.state, metrics = self.step_fn(self.state, tb)
            self.step += 1
            out = {k: float(v) for k, v in metrics.items()}
        out["staleness"] = float(self.step - 1 - batch.version)
        out["buffer_len"] = float(len(self.buffer))
        self.history.append(self.step, out)
        # per-step fan-in to the unified registry: every scalar becomes a
        # learner_* gauge, and the paper's Fig. 4/5 stability quantities
        # additionally land as per-sampler gauges (the sampler whose
        # batch this step consumed) — live staleness / KL / IW-variance
        if obs.metrics.enabled:
            obs.metrics.set_many("learner", out)
            obs.metrics.gauge("learner_steps_total").set(self.step)
            for k in ("staleness", "kl", "iw_var"):
                if k in out:
                    obs.metrics.gauge(
                        f"sampler_{k}",
                        f"{k} of the last batch trained from this sampler",
                        sampler=batch.sampler_id).set(out[k])
        if self.step % self.hcfg.sync_interval_steps == 0:
            with obs.trace.span("publish_checkpoint", track="learner",
                                step=self.step):
                self._publish()
        return out
