"""Continuous-batching engine: persistent slot pool over a paged KV cache.

The port of ``repro/sampling/continuous.py`` without speculative decoding
(a later slice):

- ``submit()`` queues a :class:`repro_torch.serving.api.Request`;
- ``step()`` runs one scheduler round: admission (priority classes,
  deadlines, shared-prefix page reuse with copy-on-write), one prefill
  chunk per prefilling slot, then one decode chunk of ``sync_every``
  steps over every slot, and returns the round's token events;
- ``generate()`` submits a batch and steps until it drains;
- ``generate_continuous()`` is the batch wrapper that returns the
  engine-agnostic rollout dict (``rollout_from_results``).

The engine owns the device state (page pools, per-slot logits); the
scheduler owns the host bookkeeping (block table, allocator, prefix
cache). Token draws are keyed per request, never per slot: draw ``g`` of
request ``rid`` depends only on (seed, rid, g, logits).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.config import ModelConfig, RLConfig
from repro_torch.data.tasks import EOS, PAD
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import decode_step, forward
from repro_torch.sampling.paged_cache import (PageAllocator, SCRATCH_PAGE,
                                              init_paged_pool,
                                              paged_cache_supported,
                                              pages_for)
from repro_torch.sampling.prefix_cache import PrefixCache
from repro_torch.sampling.sample import (mask_vocab, model_logp,
                                         sample_token_rows)
from repro_torch.sampling.scheduler import (DECODE, PREFILL,
                                            ContinuousScheduler, GenRequest)
from repro_torch.serving.api import (GenerationResult, Request,
                                     SamplingParams, TokenEvent)


def _live_width(need_pages: int, cap: int) -> int:
    """Block-table width handed to a chunk: the live-page high-water mark
    rounded up to a power of two, capped at ``pages_per_slot``. Every page
    dropped is masked in attention anyway, so narrowing changes no
    output; it bounds how far the kernels' page loops can reach."""
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
                 seed: int = 0) -> None:
        if not paged_cache_supported(cfg):
            raise ValueError(f"{cfg.name}: continuous engine needs an "
                             "attention-only decode cache (no enc-dec / "
                             "ring-KV / modality memory)")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if spec_k > 0:
            raise NotImplementedError(
                "speculative decoding (spec_k > 0) is not ported yet: "
                "ROADMAP queue 1 'Speculative decoding'")
        self.cfg, self.rl, self.params = cfg, rl, params
        self.device = params["embed"].device
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
                                    device=self.device)
        self.seed = seed
        self._last = torch.zeros((num_slots, cfg.padded_vocab),
                                 dtype=torch.float32, device=self.device)
        self._pos = np.zeros((num_slots,), np.int64)
        self._active = np.zeros((num_slots,), bool)
        self._gen = np.zeros((num_slots,), np.int64)
        self._max_new = np.ones((num_slots,), np.int64)
        self._rids = np.zeros((num_slots,), np.int64)
        self._results: Dict[int, GenerationResult] = {}

    # ------------------------------------------------------------------
    @property
    def profile(self) -> tuple:
        return (self.rl.temperature, self.rl.top_k, self.rl.top_p)

    @property
    def free_pages(self) -> int:
        return self.sched.allocator.available

    def has_work(self) -> bool:
        return (self.sched.queue_depth > 0
                or any(r is not None for r in self.sched.slots))

    def update_params(self, params: Any) -> None:
        """Serve ``params`` from now on. The prefix cache is keyed on
        tokens only and its pages hold KV of the old weights, so it is
        emptied."""
        self.params = params
        if self.prefix_cache is not None:
            self.prefix_cache.clear()

    def stats(self) -> Dict[str, float]:
        out: Dict[str, float] = dict(self.sched.stats)
        out["slot_utilization"] = self.sched.slot_utilization()
        out["free_pages"] = self.free_pages
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

    # ------------------------------------------------------------------
    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr).to(self.device)

    def _prefill_chunk(self, page_row: np.ndarray, chunk: np.ndarray,
                       start: int) -> torch.Tensor:
        """One chunk of one request's prompt: tokens at positions
        ``start + [0, C)``, K/V written into the request's pages. Returns
        logits (C, V)."""
        tokens = self._tensor(chunk[None].astype(np.int64))
        positions = start + torch.arange(chunk.shape[0], device=self.device)
        logits, _, _ = forward(self.cfg, self.params, tokens,
                               positions=positions[None], cache=self.pool,
                               page_table=self._tensor(page_row))
        return logits[0]

    def _decode_chunk(self, bt: np.ndarray):
        """``sync_every`` decode steps over every slot; returns (toks,
        lps) as (sync_every, num_slots) device tensors.

        Slots that finish mid-chunk (EOS / token budget) keep decoding
        PAD at position ``width * page_size``, past the block table, so
        their K/V write is dropped: with shared prefixes a dead slot must
        write nowhere. Draw ``i`` of slot ``s`` is draw ``gen[s] + i`` of
        its request; the host discards draws past EOS."""
        rl = self.rl
        page_table = self._tensor(bt)
        pos = self._tensor(self._pos)
        gen0 = self._tensor(self._gen)
        max_new = self._tensor(self._max_new)
        rids = self._tensor(self._rids)
        done = ~self._tensor(self._active)
        oob_pos = bt.shape[1] * self.page_size
        last = self._last
        toks, lps = [], []
        for i in range(self.sync_every):
            dead = done | ((gen0 + i) >= max_new)
            lg = mask_vocab(last, self.vocab_limit)
            tok = sample_token_rows(self.seed, rids, gen0 + i, lg,
                                    temperature=rl.temperature,
                                    top_k=rl.top_k, top_p=rl.top_p)
            lp = torch.where(dead, 0.0, model_logp(last, tok))
            tok = torch.where(dead, PAD, tok)
            step_pos = torch.where(dead, oob_pos, pos + i)
            last, _ = decode_step(self.cfg, self.params, self.pool, tok,
                                  step_pos, page_table=page_table)
            done = done | (tok == EOS)
            toks.append(tok)
            lps.append(lp)
        self._last = last
        return torch.stack(toks), torch.stack(lps)

    @torch.no_grad()
    def step(self, now_s: Optional[float] = None) -> List[TokenEvent]:
        """One scheduler round: admit -> one prefill chunk per prefilling
        slot -> one decode chunk. Returns this round's token events."""
        now = time.perf_counter() if now_s is None else now_s
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
            logits_c = self._prefill_chunk(
                sched.block_table[pref.slot:pref.slot + 1, :width], chunk,
                c0)
            sched.stats["prefill_chunks"] += 1
            pref.prefill_pos = min(pref.prompt_len, c0 + cw)
            sched.stats["prefill_tokens"] += pref.prefill_pos - c0
            if pref.prefill_pos >= pref.prompt_len:  # prompt fully cached
                s = pref.slot
                self._last[s] = logits_c[pref.prompt_len - 1 - c0]
                pref.state = DECODE
                self._active[s], self._pos[s] = True, pref.prompt_len
                self._gen[s], self._max_new[s] = 0, pref.max_new
                self._rids[s] = pref.rid
                if self.prefix_cache is not None:
                    self.prefix_cache.insert(
                        pref.prompt,
                        pref.pages[:pages_for(pref.prompt_len,
                                              self.page_size)])

        dec = sched.decoding()
        if not dec:
            return events
        # non-decoding slots attend the scratch page; their writes are
        # dropped (dead). The table is narrowed to the live high-water
        # mark over this chunk.
        width = _live_width(
            pages_for(int(self._pos[self._active].max()) + self.sync_every,
                      self.page_size),
            self.pages_per_slot)
        bt = sched.block_table[:, :width].copy()
        bt[~self._active] = SCRATCH_PAGE
        toks, lps = self._decode_chunk(bt)
        sched.stats["decode_steps"] += self.sync_every
        # the one host sync per chunk: the scheduler needs the tokens
        tok_np, lp_np = toks.cpu().numpy(), lps.cpu().numpy()
        for r in dec:
            for i in range(self.sync_every):
                if r.gen_count >= r.max_new:
                    break
                t = int(tok_np[i, r.slot])
                r.tokens.append(t)
                r.logps.append(float(lp_np[i, r.slot]))
                sched.stats["decode_slot_steps"] += 1
                if r.gen_count == 1:
                    r.t_first_token = now
                events.append(TokenEvent(rid=r.rid, token=t,
                                         logp=r.logps[-1],
                                         index=r.gen_count - 1))
                if t == EOS:
                    break
            self._pos[r.slot] = r.next_pos
            self._gen[r.slot] = r.gen_count
            reason = ""
            if r.tokens and r.tokens[-1] == EOS:
                reason = "eos"
            elif r.gen_count >= r.max_new:
                reason = "length"
            if reason:
                self._active[r.slot] = False
                sched.finish(r, reason, now)
                self._finish_result(r)
                events.append(TokenEvent(rid=r.rid, token=-1, logp=0.0,
                                         index=r.gen_count, finished=True,
                                         finish_reason=reason))
        return events

    # ------------------------------------------------------------------
    def generate(self, requests: Sequence[Request],
                 seed: Optional[int] = None) -> List[GenerationResult]:
        """Submit ``requests``, step until they all finish, return results
        in request order."""
        if seed is not None:
            self.seed = seed
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
                        seed: int = 0, *, max_new: Optional[int] = None,
                        vocab_limit: Optional[int] = None,
                        num_slots: Optional[int] = None,
                        page_size: int = 16,
                        prefill_chunk: Optional[int] = None,
                        prompt_lens: Optional[Sequence[int]] = None,
                        sync_every: int = 8,
                        prefix_cache: bool = False) -> Dict[str, Any]:
    """Continuous-batching generation over ``prompts`` (B, Tp): the
    rollout dict of ``rollout_from_results`` on the params' device, plus
    the engine's ``stats``.

    ``seed`` keys the token draws (the JAX package takes a PRNG key: the
    port's draws are keyed per request by (seed, rid, draw index), rid
    being the row). ``num_slots`` decode slots (default min(B, 8)) are
    recycled as requests finish, ``prompt_lens`` admits per-row true
    prompt lengths, ``prefill_chunk`` bounds the prompt tokens prefilled
    per chunk (default: the whole prompt), ``sync_every`` is the decode
    horizon, ``prefix_cache`` turns on shared-prefix page reuse."""
    max_new = max_new or rl.max_new_tokens
    prompts_np = np.asarray(prompts.cpu() if isinstance(prompts, torch.Tensor)
                            else prompts)
    b, tp = prompts_np.shape
    engine = ContinuousEngine(
        cfg, params, rl=rl, max_total_tokens=tp + max_new,
        num_slots=min(b, num_slots or 8), page_size=page_size,
        sync_every=sync_every,
        prefill_chunk=clamp_prefill_chunk(prefill_chunk, tp),
        vocab_limit=vocab_limit, prefix_cache=prefix_cache, seed=seed)
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
