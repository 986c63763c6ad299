"""Continuous-batching engine: persistent slot pool over a paged KV cache.

The port of ``repro/sampling/continuous.py``:

- ``submit()`` queues a :class:`repro_torch.serving.api.Request`;
- ``step()`` runs one scheduler round: admission (priority classes,
  deadlines, shared-prefix page reuse with copy-on-write), one prefill
  chunk per prefilling slot, then one decode chunk of ``sync_every``
  steps over every slot (or, with ``spec_k > 0``, one speculative round),
  and returns the round's token events;
- ``generate()`` submits a batch and steps until it drains;
- ``generate_continuous()`` is the batch wrapper that returns the
  engine-agnostic rollout dict (``rollout_from_results``).

The engine owns the device state (page pools, per-slot logits); the
scheduler owns the host bookkeeping (block table, allocator, prefix
cache). Token draws are keyed per request, never per slot: draw ``g`` of
request ``rid`` uses the threefry key ``fold_in(fold_in(key, rid), g)``,
as in the JAX package, so its tokens are the JAX engine's given the same
key and logits.

Speculative decoding (``spec_k > 0``, ``sampling/spec.py``) keeps the
JAX package's *pending-token* convention: the last committed token's K/V
is not yet written, so right after prefill the last prompt token is
pending (draw index -1) and draw 0 comes from row 0 of the first verify
window. Each round drafts on the host (n-gram lookup over the slot's own
history), scores every slot's window ``[pending, drafts...]`` in one
prefill-shaped forward through K4, accepts the longest prefix whose
drafts equal the replayed draws, and rewinds the rest by position only:
the pool is append-only, no page is copied. Rounds where no slot drafted
run a sequential chunk in the same convention (``_spec_decode_chunk``,
through K3). The non-speculative path keeps the last logits per slot
instead; an engine runs one convention for all its requests.

On a live ``serve`` or ``long`` plan (``plan=``; default the local plan
on the params' device) the engine is one of the plan's ranks, in lockstep
with the others; every rank emits the same tokens, those of one device:

- each rank holds its shard of the weights (the plan's fitted
  shardings: q/KV heads, FFN columns, vocab over 'model', replicated over
  'data', on ``serve``; over 'data' x 'model' on ``long``; a MoE's
  experts over 'model' and their FFN columns over 'data') and of the
  page pools (KV heads over 'model', whole over 'data', in both modes),
  and runs each forward under its ``ServeShard``
  (``runtime_context.serve_context``): K3/K4 on the q heads of its
  pools' KV-head groups, the row-parallel products summed over the
  tensor axes, the logits gathered over the vocab and drawn on every
  rank;
- rank 0 broadcasts each round's new submissions and its clock
  (``collectives.broadcast_object``), so every rank takes the same
  admission, page, prefix-cache and expiry decisions;
- a decode chunk or verify round splits its slots over the data axes
  (where they divide them): each data rank computes its slots' rows, the
  draws and log-probs are gathered, and each layer's new K/V rows are
  gathered and written on every rank, so the pools stay equal over
  'data' and a prefix hit or a copy-on-write page filled on another data
  rank holds the right bytes. A prefill chunk is one request's row: every
  data rank runs it. A ``long`` plan splits no slots (its batch is not
  split): every rank computes every row.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import obs, runtime_context
from repro_torch.config import ModelConfig, RLConfig
from repro_torch.data.tasks import EOS, PAD
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import decode_step, forward
from repro_torch.parallel import axes
from repro_torch.parallel.collectives import (all_gather_dim, all_reduce_max,
                                              broadcast_object)
from repro_torch.parallel.plan import ExecutionPlan, plan_for_params
from repro_torch.sampling.paged_cache import (PageAllocator, SCRATCH_PAGE,
                                              init_paged_pool,
                                              paged_cache_supported,
                                              pages_for)
from repro_torch.sampling.prefix_cache import PrefixCache
from repro_torch.sampling.prng import PRNGKey, as_key, fold_in
from repro_torch.sampling.sample import (mask_vocab, model_logp,
                                         sample_token_rows)
from repro_torch.sampling.scheduler import (DECODE, PREFILL,
                                            ContinuousScheduler, GenRequest)
from repro_torch.sampling.spec import (DraftProposer, NGramDrafter,
                                       accept_drafts, fused_rescore_diff)
from repro_torch.serving.api import (GenerationResult, Request,
                                     SamplingParams, TokenEvent)

# acceptance-EMA drafting gate: below _SPEC_EMA_MIN the drafter has nothing
# to offer this request (an incompressible stream) and more drafts only
# widen the verify window; a backed-off request drafts again every
# _SPEC_PROBE_EVERY rounds in case the stream turns templated
_SPEC_EMA_MIN = 0.25
_SPEC_EMA_DECAY = 0.5
_SPEC_PROBE_EVERY = 4


def _live_width(need_pages: int, cap: int) -> int:
    """Width handed to a chunk (block-table pages, or verify-window
    columns): ``need_pages`` rounded up to a power of two, capped at
    ``cap``. Every page dropped is masked in attention anyway, so
    narrowing changes no output; it bounds how far the kernels' page
    loops can reach."""
    w = 1
    while w < need_pages:
        w *= 2
    return min(w, cap)


def clamp_prefill_chunk(prefill_chunk: Optional[int],
                        limit: int) -> Optional[int]:
    """Clamp a configured prefill chunk width to ``limit`` tokens; None/0
    ("prefill everything in one chunk") stays None."""
    if not prefill_chunk:
        return None
    return min(prefill_chunk, limit)


def _copy_page(pool: Dict, src: int, dst: int) -> None:
    """Copy physical page ``src`` onto ``dst`` in every layer's K/V pools,
    in place: the copy-on-write step of shared-prefix admission."""
    for layer in pool.values():
        for leaf in layer["self"].values():      # (nb, pages, page, Hkv, D)
            leaf[:, dst] = leaf[:, src]


class ContinuousEngine:
    """Persistent continuous-batching engine over one model + page pool.

    One engine serves one sampling *profile* (temperature/top-k/top-p;
    ``max_new_tokens`` is per request) and one page-pool capacity. It runs
    on the device its params live on. Capacity knobs come from
    ``ServeConfig`` through ``repro_torch.sampling.build_engine``.
    ``spec_k`` drafts per verify round (0 = off), drafted by ``drafter``
    (default an :class:`NGramDrafter` of ``spec_ngram_min`` to
    ``spec_ngram_max``); ``spec_rescore`` replays each round's attention
    through one folded K4 launch and keeps the max difference
    (``stats()["spec_rescore_max_diff"]``). ``key`` (default
    ``PRNGKey(0)``) keys the draws: request ``rid`` draws with
    ``fold_in(key, rid)``. ``plan`` (default the local plan on the params'
    device) is the ``serve`` or ``long`` plan the engine runs on (module
    note); on a live one ``params`` are full leaves, cut here, or this
    rank's shards, taken as they are.
    """

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any], *,
                 rl: RLConfig, max_total_tokens: int,
                 num_slots: int = 8,
                 page_size: int = 16,
                 sync_every: int = 8,
                 prefill_chunk: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 vocab_limit: Optional[int] = None,
                 prefix_cache: bool = True,
                 prefix_cache_entries: int = 64,
                 spec_k: int = 0,
                 drafter: Optional[DraftProposer] = None,
                 spec_ngram_max: int = 3,
                 spec_ngram_min: int = 1,
                 spec_rescore: bool = True,
                 key: Optional[torch.Tensor] = None,
                 plan: Optional[ExecutionPlan] = None) -> None:
        if not paged_cache_supported(cfg):
            raise ValueError(f"{cfg.name}: continuous engine needs an "
                             "attention-only decode cache (no enc-dec / "
                             "ring-KV / modality memory)")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        self.cfg, self.rl = cfg, rl
        self.plan = plan if plan is not None else \
            plan_for_params(params, "serve")
        # this rank's part of the model; None off a live mesh, where the
        # engine runs the single-device path unchanged
        self.shard = self.plan.serve_shard(cfg)
        self.params = params if self.shard is None else \
            self.plan.adopt_params(cfg, params)
        self.device = self.params["embed"].device
        self.vocab_limit = vocab_limit or cfg.padded_vocab
        self.num_slots = num_slots
        self.page_size = page_size
        self.sync_every = sync_every
        self.prefill_chunk = prefill_chunk
        self.max_total_tokens = max_total_tokens
        self.pages_per_slot = pages_for(max_total_tokens, page_size)
        self.num_pages = num_pages or 1 + num_slots * self.pages_per_slot
        if self.num_pages < 1 + self.pages_per_slot:
            raise ValueError(
                f"num_pages={self.num_pages} cannot hold even one "
                f"max-size request ({self.pages_per_slot} pages + scratch)")
        allocator = PageAllocator(self.num_pages)
        self.prefix_cache = (PrefixCache(page_size, allocator,
                                         max_entries=prefix_cache_entries)
                             if prefix_cache else None)
        self.sched = ContinuousScheduler(num_slots, self.pages_per_slot,
                                         page_size, allocator,
                                         prefix_cache=self.prefix_cache)
        self.pool = init_paged_pool(cfg, self.num_pages, page_size,
                                    device=self.device,
                                    plan=None if self.shard is None
                                    else self.plan)
        # the slots this rank computes in a decode chunk or verify round:
        # [lo, lo + n) of num_slots, split over the data axes (of size > 1)
        # where they divide the slots (the reference's fitted batch spec);
        # whole on a ``long`` plan, whose batch is not split
        self._row_axes: tuple = ()
        self._lo, self._n = 0, num_slots
        self._inbox: List[Request] = []      # submissions of this round
        if self.shard is not None and self.shard.batch:
            mesh = self.plan.mesh
            spec = axes.fit_spec(mesh, axes.P(self.shard.batch),
                                 (num_slots,))
            self._row_axes = tuple(a for a in axes.entry_axes(spec[0])
                                   if mesh.shape[a] > 1)
            self._n = num_slots // mesh.axes_size(self._row_axes)
            self._lo = mesh.axis_index(self._row_axes) * self._n
        self.key = PRNGKey(0) if key is None else as_key(key)
        self.spec_k = spec_k
        self.spec_rescore = spec_rescore
        self.drafter: Optional[DraftProposer] = drafter
        if spec_k > 0 and drafter is None:
            self.drafter = NGramDrafter(max_ngram=spec_ngram_max,
                                        min_ngram=spec_ngram_min)
        self._last = torch.zeros((self._n, cfg.padded_vocab),
                                 dtype=torch.float32, device=self.device)
        self._pos = np.zeros((num_slots,), np.int64)
        self._active = np.zeros((num_slots,), bool)
        self._gen = np.zeros((num_slots,), np.int64)
        self._max_new = np.ones((num_slots,), np.int64)
        # each slot's request key, fold_in(key, rid): two uint32 words
        self._req_keys = np.zeros((num_slots, 2), np.int64)
        self._results: Dict[int, GenerationResult] = {}
        self._rescore_max_diff = 0.0
        # per-request acceptance EMA ([ema, rounds since the last draft]):
        # gates drafting off on incompressible streams, with a re-probe
        self._spec_ema: Dict[int, List[float]] = {}
        # observability (repro_torch.obs): handles bound once; each use is
        # one enabled-check while the registry is off
        m = obs.metrics
        self._tr = obs.trace
        self._m_prefill_chunks = m.counter(
            "engine_prefill_chunks_total", "prefill chunks executed")
        self._m_prefill_tokens = m.counter(
            "engine_prefill_tokens_total", "prompt tokens prefilled")
        self._m_decode_steps = m.counter(
            "engine_decode_steps_total", "decode steps executed")
        self._m_cow = m.counter(
            "engine_cow_copies_total", "shared-prefix copy-on-write copies")
        self._g_free_pages = m.gauge(
            "engine_free_pages", "KV pages on the free list")
        self._g_queue = m.gauge(
            "engine_queue_depth", "requests queued behind admission")
        self._g_slot_util = m.gauge(
            "engine_slot_utilization", "decode-slot occupancy (instant)")
        self._g_prefix_hits = m.gauge(
            "engine_prefix_cache_hits", "shared-prefix cache hits")
        self._g_prefix_reused = m.gauge(
            "engine_prefix_tokens_reused",
            "prompt tokens served from cached prefix pages")
        self._m_spec_rounds = m.counter(
            "engine_spec_rounds_total", "speculative verification rounds")
        self._m_spec_drafted = m.counter(
            "engine_spec_drafted_total", "draft tokens proposed")
        self._m_spec_accepted = m.counter(
            "engine_spec_accepted_total", "draft tokens accepted")
        self._g_accept_rate = m.gauge(
            "engine_spec_accept_rate",
            "accepted / drafted tokens (cumulative)")
        self._g_draft_hit = m.gauge(
            "engine_spec_draft_hit_rate",
            "slot-rounds where the drafter proposed anything (cumulative)")
        self._g_rescore_diff = m.gauge(
            "engine_spec_rescore_max_diff",
            "max |fused-layers rescore - in-forward attention| last round")

    # ------------------------------------------------------------------
    @property
    def profile(self) -> tuple:
        return (self.rl.temperature, self.rl.top_k, self.rl.top_p)

    @property
    def free_pages(self) -> int:
        return self.sched.allocator.available

    @property
    def evictable_pages(self) -> int:
        """Pages a prefix-cache flush could return to the free list."""
        if self.prefix_cache is None:
            return 0
        alloc = self.sched.allocator
        return sum(1 for ent in self.prefix_cache._entries.values()
                   for pg in ent.pages if alloc.refcount(pg) == 1)

    def has_work(self) -> bool:
        return (bool(self._inbox) or self.sched.queue_depth > 0
                or any(r is not None for r in self.sched.slots))

    def update_params(self, params: Any) -> None:
        """Serve ``params`` from now on (re-placed on a live plan: full
        leaves cut, shards taken). The prefix cache is keyed on tokens only
        and its pages hold KV of the old weights, so it is emptied."""
        self.params = params if self.shard is None else \
            self.plan.adopt_params(self.cfg, params)
        if self.prefix_cache is not None:
            self.prefix_cache.clear()

    def stats(self) -> Dict[str, float]:
        out: Dict[str, float] = dict(self.sched.stats)
        out["slot_utilization"] = self.sched.slot_utilization()
        out["free_pages"] = self.free_pages
        out["accept_rate"] = (out["accepted_tokens_total"]
                              / max(out["drafted_tokens_total"], 1))
        out["draft_hit_rate"] = (out["draft_hits"]
                                 / max(out["spec_slot_rounds"], 1))
        out["spec_rescore_max_diff"] = self._rescore_max_diff
        if self.prefix_cache is not None:
            for k, v in self.prefix_cache.stats.items():
                out[f"prefix_cache_{k}"] = v
        return out

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Queue a request. Raises on a profile mismatch and on prompts
        that can never fit the page budget."""
        if req.params.profile != self.profile:
            raise ValueError(
                f"request {req.rid}: sampling profile {req.params.profile} "
                f"!= engine profile {self.profile} — one profile per "
                "engine (max_new_tokens may vary per request)")
        total = req.prompt_len + req.params.max_new_tokens
        if pages_for(total, self.page_size) > self.pages_per_slot:
            raise ValueError(
                f"request {req.rid}: {total} tokens exceed the engine's "
                f"max_total_tokens={self.max_total_tokens}")
        if self.shard is not None:       # rank 0's go out with the round
            self._inbox.append(req)
            return
        self._enqueue(req)

    def _enqueue(self, req: Request) -> None:
        self.sched.submit(GenRequest(
            rid=req.rid, prompt=req.prompt,
            max_new=req.params.max_new_tokens, priority=req.priority,
            deadline_s=req.deadline_s, arrival_s=req.arrival_s,
            spec_ok=req.params.spec))

    def _finish_result(self, r: GenRequest) -> GenerationResult:
        res = GenerationResult(
            rid=r.rid, tokens=np.asarray(r.tokens, np.int32),
            logps=np.asarray(r.logps, np.float32),
            finish_reason=r.finish_reason, prompt_len=r.prompt_len,
            prefix_hit_tokens=r.prefix_hit_tokens,
            ttft_s=(r.t_first_token - r.arrival_s
                    if r.t_first_token >= 0 else float("nan")),
            latency_s=r.t_done - r.arrival_s)
        self._results[r.rid] = res
        return res

    def pop_result(self, rid: int) -> Optional[GenerationResult]:
        return self._results.pop(rid, None)

    def _publish_gauges(self) -> None:
        """Page-pool / queue / prefix-cache gauges, once per ``step``."""
        if not obs.metrics.enabled:
            return
        sched = self.sched
        self._g_free_pages.set(self.free_pages)
        self._g_queue.set(sched.queue_depth)
        self._g_slot_util.set(
            sum(1 for r in sched.slots if r is not None)
            / max(self.num_slots, 1))
        if self.prefix_cache is not None:
            st = self.prefix_cache.stats
            self._g_prefix_hits.set(st.get("hits", 0))
            self._g_prefix_reused.set(st.get("tokens_reused", 0))

    # ------------------------------------------------------------------
    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        # the round's host-side inputs (block table, positions, keys) go
        # to the card: a copy from pageable memory, which waits
        return torch.as_tensor(arr).to(self.device)  # noqa: RA003 — round inputs

    def _serving(self, split: bool):
        """The rank's shard around a forward: with ``split`` (a decode
        chunk or verify round) its rows split over the data axes. Nothing
        off a live mesh."""
        if self.shard is None:
            return contextlib.nullcontext()
        return runtime_context.serve_context(
            self.shard.with_rows(self._row_axes) if split else self.shard)

    def _own(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slots of a (num_slots, ...) tensor."""
        return t[self._lo:self._lo + self._n]

    def _all(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's slots of a (n, ...) tensor, in slot order."""
        return all_gather_dim(t, self.plan.mesh, self._row_axes, 0)

    def _prefill_chunk(self, page_row: np.ndarray, chunk: np.ndarray,
                       start: int) -> torch.Tensor:
        """One chunk of one request's prompt: tokens at positions
        ``start + [0, C)``, K/V written into the request's pages. Returns
        the logits of its last token (V,): a request draws from its
        prompt's last token once its last chunk is in."""
        tokens = self._tensor(chunk[None].astype(np.int64))
        positions = start + torch.arange(chunk.shape[0], device=self.device)
        with self._serving(split=False):
            logits, _, _ = forward(self.cfg, self.params, tokens,
                                   positions=positions[None],
                                   cache=self.pool,
                                   page_table=self._tensor(page_row),
                                   last_only=True)
        return logits[0, -1]

    def _decode_chunk(self, bt: np.ndarray):
        """``sync_every`` decode steps over every slot; returns (toks,
        lps) as (sync_every, num_slots) device tensors.

        Slots that finish mid-chunk (EOS / token budget) keep decoding
        PAD at position ``width * page_size``, past the block table, so
        their K/V write is dropped: with shared prefixes a dead slot must
        write nowhere. Draw ``i`` of slot ``s`` is draw ``gen[s] + i`` of
        its request; the host discards draws past EOS. A rank whose slots
        split over 'data' draws its own slots' rows (``_last`` holds their
        logits) and gathers the draws."""
        rl = self.rl
        page_table = self._tensor(bt)
        pos = self._tensor(self._pos)
        gen0 = self._tensor(self._gen)
        max_new = self._tensor(self._max_new)
        req_keys = self._tensor(self._req_keys)
        done = ~self._tensor(self._active)
        oob_pos = bt.shape[1] * self.page_size
        keys, gen = self._own(req_keys), self._own(gen0)
        last = self._last
        toks, lps = [], []
        with self._serving(split=True):
            for i in range(self.sync_every):
                dead = done | ((gen0 + i) >= max_new)
                lg = mask_vocab(last, self.vocab_limit)
                tok = sample_token_rows(fold_in(keys, gen + i), lg,
                                        temperature=rl.temperature,
                                        top_k=rl.top_k, top_p=rl.top_p)
                lp = self._all(model_logp(last, tok))
                tok = self._all(tok)
                lp = torch.where(dead, 0.0, lp)
                tok = torch.where(dead, PAD, tok)
                step_pos = torch.where(dead, oob_pos, pos + i)
                last, _ = decode_step(self.cfg, self.params, self.pool, tok,
                                      step_pos, page_table=page_table)
                done = done | (tok == EOS)
                toks.append(tok)
                lps.append(lp)
        self._last = last
        return torch.stack(toks), torch.stack(lps)

    def _spec_decode_chunk(self, bt: np.ndarray, pending: np.ndarray,
                           pos0: np.ndarray, gen_base: np.ndarray):
        """The decode chunk in the pending-token convention: the spec
        engine's fallback for rounds where no slot drafted. Each step
        writes the carried token's K/V and draws the next from its logits,
        so no last-logits state is needed and the chunk's last draw stays
        pending. Draw ``i`` is draw ``gen_base + 1 + i``, the counter the
        verify round replays, so tokens are the same whichever path emits
        them. Returns (toks, lps) as (sync_every, num_slots)."""
        rl = self.rl
        page_table = self._tensor(bt)
        tok = self._tensor(pending)
        pos0_t = self._tensor(pos0)
        gen_base_t = self._tensor(gen_base)
        max_new = self._tensor(self._max_new)
        req_keys = self._tensor(self._req_keys)
        done = ~self._tensor(self._active)
        oob_pos = bt.shape[1] * self.page_size
        keys = self._own(req_keys)
        toks, lps = [], []
        with self._serving(split=True):
            for i in range(self.sync_every):
                gi = gen_base_t + 1 + i
                dead = done | (gi >= max_new)
                step_pos = torch.where(dead, oob_pos, pos0_t + i)
                logits, _ = decode_step(self.cfg, self.params, self.pool,
                                        tok, step_pos, page_table=page_table)
                nt = sample_token_rows(fold_in(keys, self._own(gi)),
                                       mask_vocab(logits, self.vocab_limit),
                                       temperature=rl.temperature,
                                       top_k=rl.top_k, top_p=rl.top_p)
                lp = self._all(model_logp(logits, nt))
                nt = self._all(nt)
                lp = torch.where(dead, 0.0, lp)
                tok = torch.where(dead, PAD, nt)
                done = done | (tok == EOS)
                toks.append(tok)
                lps.append(lp)
        return torch.stack(toks), torch.stack(lps)

    def _verify_chunk(self, bt: np.ndarray, packed: np.ndarray):
        """One speculative round over every slot: score each slot's window
        ``[pending, d_1..d_k, pad]`` in ONE prefill-shaped forward (K4;
        positions ``pos0 + [0, W)``), then accept the longest draft prefix
        matching the replayed draws (``spec.accept_drafts``).

        ``packed`` (B, W+7) holds what changes per round, in one transfer:
        ``[window(W), draft_len, gen_base, pos0, active, key(2),
        max_new]``, ``key`` the slot's request key.
        Every window column writes its K/V at its position; rejected and
        padded columns land on the slot's own reserved-but-unread slots
        (or the scratch page) and are overwritten before any query can
        attend them: the append-only rollback. Inactive slots run at
        ``[0, W)`` against the scratch page. With ``spec_rescore`` the
        forward records every layer's queries and attention outputs, and
        ``spec.fused_rescore_diff`` replays them through one folded K4
        launch.

        Returns (iout (B, W+2) = [toks(W), n_emit, n_acc], fout (B, W+1)
        = [lps(W), rescore diff]) on the device."""
        rl = self.rl
        w = packed.shape[1] - 7
        t = self._tensor(packed)
        window = t[:, :w]
        draft_len, gen_base, pos0 = t[:, w], t[:, w + 1], t[:, w + 2]
        active, req_keys = t[:, w + 3].bool(), t[:, w + 4:w + 6]
        max_new = t[:, w + 6]
        page_table = self._tensor(bt)
        positions = pos0[:, None] + torch.arange(w, device=self.device)
        with self._serving(split=True):
            logits, _, aux = forward(self.cfg, self.params, window,
                                     positions=positions, cache=self.pool,
                                     page_table=page_table,
                                     record_queries=self.spec_rescore)
        own = self._own
        toks, lps, n_emit, n_acc = accept_drafts(
            logits, own(window), own(draft_len), own(active), own(req_keys),
            own(gen_base), own(max_new), temperature=rl.temperature,
            top_k=rl.top_k, top_p=rl.top_p, vocab_limit=self.vocab_limit)
        diff = torch.zeros((), dtype=torch.float32, device=self.device)
        if self.spec_rescore:
            # this rank's rows and heads; the round's max over every rank
            diff = fused_rescore_diff(self.cfg, self.pool, aux["q_tape"],
                                      aux["o_tape"], own(page_table),
                                      own(positions))
            if self.shard is not None:
                mesh = self.plan.mesh
                diff = all_reduce_max(diff.reshape(1), mesh, tuple(
                    a for a in mesh.axis_names if mesh.shape[a] > 1))[0]
        iout = torch.cat([toks, n_emit[:, None], n_acc[:, None]], dim=1)
        fout = torch.cat([lps, diff.expand(lps.shape[0], 1)], dim=1)
        return self._all(iout), self._all(fout)

    # ------------------------------------------------------------------
    def _append(self, r: GenRequest, toks, lps, now: float,
                events: List[TokenEvent]) -> int:
        """Commit draws to ``r`` in order, up to its token budget and
        through an EOS; returns how many were committed."""
        n = 0
        for t, lp in zip(toks, lps):
            if r.gen_count >= r.max_new:
                break
            t = int(t)
            r.tokens.append(t)
            r.logps.append(float(lp))
            n += 1
            if r.gen_count == 1:
                r.t_first_token = now
            events.append(TokenEvent(rid=r.rid, token=t, logp=r.logps[-1],
                                     index=r.gen_count - 1))
            if t == EOS:
                break
        return n

    def _settle(self, r: GenRequest, now: float,
                events: List[TokenEvent]) -> None:
        """After a chunk or round: record ``r``'s position and draw count,
        and finish it at an EOS or its budget."""
        s = r.slot
        self._pos[s] = r.next_pos
        self._gen[s] = r.gen_count
        reason = ""
        if r.tokens and r.tokens[-1] == EOS:
            reason = "eos"
        elif r.gen_count >= r.max_new:
            reason = "length"
        if reason:
            self._active[s] = False
            self._spec_ema.pop(r.rid, None)
            self.sched.finish(r, reason, now)
            self._finish_result(r)
            events.append(TokenEvent(rid=r.rid, token=-1, logp=0.0,
                                     index=r.gen_count, finished=True,
                                     finish_reason=reason))

    def _chunk_table(self, top_pos: int) -> np.ndarray:
        """The block table for a chunk that writes up to ``top_pos``
        (exclusive), narrowed to the live high-water mark; non-decoding
        slots attend (and write) the scratch page, never position 0 of
        pages a prefilling request has already filled."""
        width = _live_width(pages_for(top_pos, self.page_size),
                            self.pages_per_slot)
        bt = self.sched.block_table[:, :width].copy()
        bt[~self._active] = SCRATCH_PAGE
        return bt

    @torch.no_grad()
    def step(self, now_s: Optional[float] = None) -> List[TokenEvent]:
        """One scheduler round: admit -> one prefill chunk per prefilling
        slot -> one decode chunk (or speculative round). Returns this
        round's token events."""
        now = time.perf_counter() if now_s is None else now_s
        if self.shard is not None:
            # lockstep: every rank takes rank 0's clock and submissions
            now, reqs = broadcast_object((now, self._inbox), self.plan.mesh)
            self._inbox = []
            for req in reqs:
                self._enqueue(req)
        events: List[TokenEvent] = []
        sched = self.sched
        newly = sched.admit(now)
        for r in sched.drain_expired():
            self._finish_result(r)
            events.append(TokenEvent(rid=r.rid, token=-1, logp=0.0, index=0,
                                     finished=True, finish_reason="expired"))
        for r in newly:
            if r.cow_src >= 0:
                _copy_page(self.pool, r.cow_src, r.cow_dst)
                sched.stats["cow_copies"] += 1
                self._m_cow.inc()
        if not newly and sched.queue_depth > 0 \
                and all(r is None for r in sched.slots):
            raise RuntimeError(
                "admission stalled with an empty slot pool: the page pool "
                f"({self.num_pages} pages) cannot fit the head request "
                "even after prefix-cache eviction")

        # chunked prefill: every prefilling slot advances one chunk
        for pref in [r for r in sched.slots
                     if r is not None and r.state == PREFILL]:
            c0 = pref.prefill_pos
            remaining = pref.prompt_len - c0
            cw = clamp_prefill_chunk(self.prefill_chunk,
                                     remaining) or remaining
            chunk = pref.prompt[c0:c0 + cw]
            width = _live_width(pages_for(c0 + cw, self.page_size),
                                self.pages_per_slot)
            with self._tr.span("prefill", track="engine", rid=pref.rid,
                               slot=pref.slot, start=c0, chunk=cw,
                               width=width):
                logits_c = self._prefill_chunk(
                    sched.block_table[pref.slot:pref.slot + 1, :width],
                    chunk, c0)
            sched.stats["prefill_chunks"] += 1
            pref.prefill_pos = min(pref.prompt_len, c0 + cw)
            sched.stats["prefill_tokens"] += pref.prefill_pos - c0
            self._m_prefill_chunks.inc()
            self._m_prefill_tokens.inc(pref.prefill_pos - c0)
            if pref.prefill_pos >= pref.prompt_len:  # prompt fully cached
                s = pref.slot
                # the spec path keeps it pending; a rank keeps its slots'
                if self.spec_k == 0 and self._lo <= s < self._lo + self._n:
                    self._last[s - self._lo] = logits_c
                pref.state = DECODE
                self._active[s], self._pos[s] = True, pref.prompt_len
                self._gen[s], self._max_new[s] = 0, pref.max_new
                self._req_keys[s] = fold_in(self.key, pref.rid).numpy()
                if self.prefix_cache is not None:
                    self.prefix_cache.insert(
                        pref.prompt,
                        pref.pages[:pages_for(pref.prompt_len,
                                              self.page_size)])

        dec = sched.decoding()
        if not dec:
            self._publish_gauges()
            return events
        if self.spec_k > 0:
            self._spec_round(dec, now, events)
            self._publish_gauges()
            return events
        bt = self._chunk_table(int(self._pos[self._active].max())
                               + self.sync_every)
        with self._tr.span("decode", track="engine", slots=len(dec),
                           chunk=self.sync_every, width=bt.shape[1]):
            toks, lps = self._decode_chunk(bt)
        sched.stats["decode_steps"] += self.sync_every
        self._m_decode_steps.inc(self.sync_every)
        # the one host sync per chunk: the scheduler needs the tokens
        tok_np, lp_np = toks.cpu().numpy(), lps.cpu().numpy()  # noqa: RA003 — once a round
        for r in dec:
            sched.stats["decode_slot_steps"] += self._append(
                r, tok_np[:, r.slot], lp_np[:, r.slot], now, events)
            self._settle(r, now, events)
        self._publish_gauges()
        return events

    def _spec_round(self, dec: List[GenRequest], now: float,
                    events: List[TokenEvent]) -> None:
        """One speculative round in place of the decode chunk: draft on the
        host, verify every slot's window in one forward, commit the
        accepted prefix and the replayed draw, rewind the rest by
        position. Drafting is gated per request by an acceptance EMA, and
        a round where no slot drafts runs ``_spec_decode_chunk``: the
        honest 1x floor instead of one token per forward."""
        sched = self.sched
        per_slot: Dict[int, tuple] = {}
        max_k = 0
        for r in dec:
            pending = r.tokens[-1] if r.tokens else int(r.prompt[-1])
            ke = min(self.spec_k, r.max_new - r.gen_count - 1) \
                if r.spec_ok else 0
            st = self._spec_ema.setdefault(r.rid, [1.0, 0])
            if ke > 0 and st[0] < _SPEC_EMA_MIN:
                st[1] += 1
                if st[1] < _SPEC_PROBE_EVERY:
                    ke = 0                      # backed off; wait to probe
                else:
                    st[1] = 0                   # probe round: draft again
            d = np.zeros((0,), np.int32)
            if ke > 0:
                hist = np.concatenate(
                    [r.prompt, np.asarray(r.tokens, np.int32)])
                d = np.asarray(self.drafter.propose(hist, ke),
                               np.int32)[:ke]
            per_slot[r.slot] = (pending, d)
            max_k = max(max_k, len(d))
        if max_k == 0:
            self._spec_fallback(dec, now, events, per_slot)
            return
        # pow2 window widths (floor 2: the prefill-shaped recording path),
        # the JAX package's, so its K4 launches have the reference's shapes
        w = max(2, _live_width(1 + max_k, self.spec_k + 1))
        packed = np.zeros((self.num_slots, w + 7), np.int64)
        packed[:, :w] = PAD
        for r in dec:
            s = r.slot
            pending, d = per_slot[s]
            packed[s, 0] = pending
            packed[s, 1:1 + len(d)] = d
            packed[s, w:w + 4] = (len(d), r.gen_count - 1,
                                  r.prompt_len + r.gen_count - 1, 1)
            packed[s, w + 4:w + 6] = self._req_keys[s]
            packed[s, w + 6] = r.max_new
        bt = self._chunk_table(int(packed[:, w + 2].max()) + w)
        with self._tr.span("verify", track="engine", slots=len(dec),
                           window=w, width=bt.shape[1]):
            iout, fout = self._verify_chunk(bt, packed)
        sched.stats["decode_steps"] += 1
        sched.stats["spec_rounds"] += 1
        self._m_decode_steps.inc(1)
        # the round's host syncs: the scheduler needs its tokens
        io, fo = iout.cpu().numpy(), fout.cpu().numpy()  # noqa: RA003 — once a round
        tok_np, ne, na = io[:, :w], io[:, w], io[:, w + 1]
        if self.spec_rescore:
            self._rescore_max_diff = max(self._rescore_max_diff,
                                         float(fo[0, w]))
        drafted = accepted = hits = 0
        for r in dec:
            s = r.slot
            dl = len(per_slot[s][1])
            drafted += dl
            accepted += int(na[s])
            hits += int(dl > 0)
            if dl > 0:
                st = self._spec_ema[r.rid]
                st[0] = (_SPEC_EMA_DECAY * st[0]
                         + (1.0 - _SPEC_EMA_DECAY) * int(na[s]) / dl)
            sched.stats["spec_slot_rounds"] += 1
            sched.stats["decode_slot_steps"] += 1
            n = int(ne[s])
            self._append(r, tok_np[s, :n], fo[s, :n], now, events)
            self._settle(r, now, events)
        sched.stats["drafted_tokens_total"] += drafted
        sched.stats["accepted_tokens_total"] += accepted
        sched.stats["draft_hits"] += hits
        if obs.metrics.enabled:
            st = sched.stats
            self._m_spec_rounds.inc()
            self._m_spec_drafted.inc(drafted)
            self._m_spec_accepted.inc(accepted)
            self._g_accept_rate.set(st["accepted_tokens_total"]
                                    / max(st["drafted_tokens_total"], 1))
            self._g_draft_hit.set(st["draft_hits"]
                                  / max(st["spec_slot_rounds"], 1))
            self._g_rescore_diff.set(self._rescore_max_diff)

    def _spec_fallback(self, dec: List[GenRequest], now: float,
                       events: List[TokenEvent],
                       per_slot: Dict[int, tuple]) -> None:
        """A no-draft round: ``_spec_decode_chunk`` over every slot."""
        sched = self.sched
        ns = self.num_slots
        pending = np.zeros((ns,), np.int64)
        pos0 = np.zeros((ns,), np.int64)
        gen_base = np.full((ns,), -1, np.int64)
        for r in dec:
            s = r.slot
            pending[s] = per_slot[s][0]
            pos0[s] = r.prompt_len + r.gen_count - 1
            gen_base[s] = r.gen_count - 1
        bt = self._chunk_table(int(pos0.max()) + self.sync_every)
        with self._tr.span("decode", track="engine", slots=len(dec),
                           chunk=self.sync_every, width=bt.shape[1]):
            toks, lps = self._spec_decode_chunk(bt, pending, pos0, gen_base)
        sched.stats["decode_steps"] += self.sync_every
        sched.stats["spec_fallback_chunks"] += 1
        self._m_decode_steps.inc(self.sync_every)
        # the chunk's one host sync: the scheduler needs the tokens
        tok_np, lp_np = toks.cpu().numpy(), lps.cpu().numpy()  # noqa: RA003 — once a round
        for r in dec:
            sched.stats["decode_slot_steps"] += self._append(
                r, tok_np[:, r.slot], lp_np[:, r.slot], now, events)
            self._settle(r, now, events)

    # ------------------------------------------------------------------
    def generate(self, requests: Sequence[Request],
                 key: Optional[torch.Tensor] = None
                 ) -> List[GenerationResult]:
        """Submit ``requests``, step until they all finish, return results
        in request order. ``key`` replaces the engine's key first."""
        if key is not None:
            self.key = as_key(key)
        pending = set()
        for req in requests:
            self.submit(req)
            pending.add(req.rid)
        while pending - self._results.keys():
            if not self.has_work():
                missing = sorted(pending - self._results.keys())
                raise RuntimeError(f"engine drained but requests {missing} "
                                   "never finished")
            self.step()
        return [self._results.pop(r.rid) for r in requests]


# --------------------------------------------------------------------------
# batch wrapper


def rollout_from_results(prompts: np.ndarray,
                         results: Sequence[GenerationResult], max_new: int,
                         device: DeviceLike = "cuda") -> Dict[str, Any]:
    """The engine-agnostic rollout dict (tokens / completions / sampler_lp
    / comp_mask as tensors on ``device``, and prompt_len) from
    per-request results. Row ``i`` is ``results[i]``; expired requests
    contribute all-PAD rows."""
    dev = resolve_device(device)
    prompts = np.asarray(prompts)
    b, tp = prompts.shape
    completions = np.full((b, max_new), PAD, np.int32)
    sampler_lp = np.zeros((b, max_new), np.float32)
    comp_mask = np.zeros((b, max_new), np.float32)
    for i, res in enumerate(results):
        n = res.gen_count
        completions[i, :n] = res.tokens
        sampler_lp[i, :n] = res.logps
        comp_mask[i, :n] = 1.0
    tokens = np.concatenate([prompts.astype(np.int32), completions], axis=1)
    return {"tokens": torch.from_numpy(tokens).to(dev),
            "completions": torch.from_numpy(completions).to(dev),
            "sampler_lp": torch.from_numpy(sampler_lp).to(dev),
            "comp_mask": torch.from_numpy(comp_mask).to(dev),
            "prompt_len": tp}


def generate_continuous(cfg: ModelConfig, rl: RLConfig, params: Dict[str, Any],
                        prompts: Union[np.ndarray, torch.Tensor],
                        key: Optional[torch.Tensor] = None, *,
                        max_new: Optional[int] = None,
                        vocab_limit: Optional[int] = None,
                        num_slots: Optional[int] = None,
                        page_size: int = 16,
                        prefill_chunk: Optional[int] = None,
                        prompt_lens: Optional[Sequence[int]] = None,
                        sync_every: int = 8,
                        prefix_cache: bool = False,
                        plan: Optional[ExecutionPlan] = None
                        ) -> Dict[str, Any]:
    """Continuous-batching generation over ``prompts`` (B, Tp): the
    rollout dict of ``rollout_from_results`` on the engine's device, plus
    the engine's ``stats``. ``plan`` is the engine's (``ContinuousEngine``):
    on a live ``serve`` plan every rank calls this with the same
    arguments and gets the same rollout.

    ``key`` (default ``PRNGKey(0)``) keys the token draws, per request
    with rid the row, as in the JAX package. ``num_slots`` decode slots
    (default min(B, 8)) are recycled as requests finish, ``prompt_lens``
    admits per-row true prompt lengths, ``prefill_chunk`` bounds the
    prompt tokens prefilled per chunk (default: the whole prompt),
    ``sync_every`` is the decode horizon, ``prefix_cache`` turns on
    shared-prefix page reuse."""
    max_new = max_new or rl.max_new_tokens
    prompts_np = np.asarray(prompts.cpu() if isinstance(prompts, torch.Tensor)
                            else prompts)
    b, tp = prompts_np.shape
    engine = ContinuousEngine(
        cfg, params, rl=rl, max_total_tokens=tp + max_new,
        num_slots=min(b, num_slots or 8), page_size=page_size,
        sync_every=sync_every,
        prefill_chunk=clamp_prefill_chunk(prefill_chunk, tp),
        vocab_limit=vocab_limit, prefix_cache=prefix_cache, key=key,
        plan=plan)
    sp = SamplingParams(temperature=rl.temperature, top_k=rl.top_k,
                        top_p=rl.top_p, max_new_tokens=max_new)
    requests = []
    for r in range(b):
        plen = int(prompt_lens[r]) if prompt_lens is not None else tp
        if not 0 < plen <= tp:
            raise ValueError(f"prompt_lens[{r}]={plen} outside (0, {tp}]")
        requests.append(Request(rid=r, prompt=prompts_np[r, :plen],
                                params=sp))
    results = engine.generate(requests)
    roll = rollout_from_results(prompts_np, results, max_new,
                                device=engine.device)
    roll["stats"] = engine.stats()
    return roll
