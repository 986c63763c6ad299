"""Real-async HeteroRL runtime: the learner and the sampler nodes as OS
threads with wall-clock delays, the port of ``repro/hetero/threads.py``
(the in-process analogue of the paper's ZeroMQ deployment, App. E.2).
The event-sim runtime (``runtime.py``) is the deterministic default; this
one shows that the node interfaces (policy store, queue transport,
version-stamped batches) carry over to true asynchrony unchanged.

Delays are scaled: 1 simulated second = ``time_scale`` wall seconds.

On a card every thread launches on the default stream, so the card runs
their kernels one after another while host work (drafting, scoring,
hashing a publish) overlaps. A node's ``generate_batch`` and ``sync``
never overlap: one thread runs both, in turn. Autograd's mode is per
thread and on in a fresh one: every sampler-side entry point (the engine's
``step``, ``token_logps``) runs under ``torch.no_grad``.

``sampler_plan`` places the samplers (default the
``HeteroConfig.sampler_mesh`` knob), ``learner_plan`` the learner. Where
either is live, sampler threads would reach their collectives in
wall-clock order, which differs by rank, so the ranks run in lockstep
with rank 0's order, as the front door's followers do: rank 0 alone runs
the sampler threads and the learner loop, and each collective section (a
sampler's ``generate_batch``, its ``sync``, the learner's receive and
step with its publish) runs under one runtime lock, granted in the order
it was asked for (so the learner waits behind at most one section of
each sampler), after rank 0 has broadcast it ("batch of sampler i at t",
"sync sampler i", "learn batch b at t") on the plan's group. The other
ranks replay that sequence
(``run`` follows it), so every rank issues the same collectives in the
same order from one thread at a time, and every rank's batches,
versions and staleness are rank 0's. The run ends with a broadcast
"stop", after rank 0 has joined its threads, so no rank waits out a
collective's timeout.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch import obs
from repro_torch.checkpoint import PolicyStore
from repro_torch.config import HeteroConfig, ModelConfig, RLConfig, TrainConfig
from repro_torch.core.diagnostics import MetricsHistory
from repro_torch.data import ArithmeticTask, PromptPipeline, Tokenizer
from repro_torch.device import DeviceLike
from repro_torch.hetero.nodes import (LearnerNode, RolloutBatch, SamplerNode,
                                      link_telemetry)
from repro_torch.parallel import ExecutionPlan, plan_from_flag
from repro_torch.parallel.collectives import broadcast_object
from repro_torch.training import TrainState


class _TicketLock:
    """A lock granted in the order it was asked for. ``threading.Lock`` is
    not fair: a sampler thread that releases it and asks again at once
    can win it against the learner every time, which then starves."""

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._next = 0
        self._serving = 0

    def __enter__(self) -> None:
        with self._cv:
            ticket, self._next = self._next, self._next + 1
            while self._serving != ticket:
                self._cv.wait()

    def __exit__(self, *exc) -> None:
        with self._cv:
            self._serving += 1
            self._cv.notify_all()


class ThreadedHeteroRuntime:
    """One learner (the calling thread) and ``hcfg.num_samplers`` sampler
    threads. ``run`` joins each sampler thread for 10 s before it returns;
    ``threads`` keeps them, so a caller can wait for one that outlived the
    run (a batch still in flight). On live plans (module note) rank 0
    runs the threads and every other rank's ``run`` replays rank 0's
    sections; ``leader`` says which this rank does."""

    def __init__(self, cfg: ModelConfig, rl: RLConfig, tc: TrainConfig,
                 hcfg: HeteroConfig, task: ArithmeticTask, tok: Tokenizer,
                 state: TrainState, *, prompts_per_batch: int = 4,
                 time_scale: float = 1e-4,
                 queue_size: int = 16,
                 device: DeviceLike = "cuda",
                 learner_plan: Optional[ExecutionPlan] = None,
                 sampler_plan: Optional[ExecutionPlan] = None) -> None:
        sampler_plan = sampler_plan or plan_from_flag(
            hcfg.sampler_mesh, "serve", device)
        self.hcfg = hcfg
        self.time_scale = time_scale
        self.store = PolicyStore()
        self.learner = LearnerNode(cfg, rl, tc, hcfg, state, self.store,
                                   device=device, plan=learner_plan)
        # the group whose rank 0 orders every collective section; None
        # when both plans are local (the threads then run unordered)
        live = [p.mesh for p in (sampler_plan, self.learner.plan)
                if p.mesh.live]
        self._mesh = live[0] if live else None
        self.leader = self._mesh is None or self._mesh.rank == 0
        # the queue carries batch ids; the batches wait in ``_pending``
        self.queue: queue.Queue[int] = queue.Queue(queue_size)
        # each sampler owns a copy of the params (SamplerNode): the
        # learner thread's in-place step never touches them
        self.samplers = [
            SamplerNode(i, cfg, rl,
                        PromptPipeline(task, tok, prompts_per_batch,
                                       rl.group_size),
                        task, tok, self.learner.full_params(), self.store,
                        hcfg, seed=hcfg.seed * 1000 + i,
                        logprob_impl=tc.logprob_impl, device=device,
                        plan=sampler_plan)
            for i in range(hcfg.num_samplers)
        ]
        self.threads: List[threading.Thread] = []
        self.errors: List[BaseException] = []
        self.skipped_syncs = 0
        self._pending: Dict[int, RolloutBatch] = {}
        self._dropped: List[int] = []     # ids the followers forget
        self._next_id = 0
        self._lock = threading.Lock()     # guards the six above
        self._section = _TicketLock()     # one collective section at once
        self._stop = threading.Event()
        self._t0 = time.monotonic()

    # wall clock stands in for the virtual clock
    def _now_s(self) -> float:
        return (time.monotonic() - self._t0) / self.time_scale

    # ---- sections: rank 0 broadcasts each, every rank applies it --------
    def _do(self, op: str, *args: Any) -> Any:
        """Run one section (``_apply``); on live plans under the runtime
        lock, after broadcasting it with the ids dropped since the last.
        Nothing runs once the run has stopped."""
        if self._mesh is None:
            return self._apply(op, args)
        with self._section:
            if self._stop.is_set():
                return None
            with self._lock:
                forget, self._dropped = self._dropped, []
            broadcast_object((op, args, forget), self._mesh)
            return self._apply(op, args)

    def _apply(self, op: str, args: Tuple) -> Any:
        if op == "gen":                   # (sampler, now, batch id)
            sid, now, bid = args
            batch = self.samplers[sid].generate_batch(now)
            with self._lock:
                self._pending[bid] = batch
            return batch
        if op == "sync":                  # (sampler,) -> bytes or None
            try:
                # chunked delta sync; the bytes moved charge
                # serialization time on the next sync gap
                return self.samplers[args[0]].sync()
            except KeyError:
                # lost the publisher's prune race even after the node's
                # retries: skip this round, the next interval syncs a
                # newer version
                with self._lock:
                    self.skipped_syncs += 1
                return None
        if op == "learn":                 # (batch id, now)
            bid, now = args
            with self._lock:
                batch = self._pending.pop(bid)
            self.learner.receive(now, batch)
            b = self.learner.pop_eligible(now)
            if b is not None:
                self.learner.train_on(b)
            return None
        raise ValueError(f"unknown section {op!r}")

    def _sampler_loop(self, s: SamplerNode) -> None:
        # this thread's trace track, so wall-clock spans land on the named
        # timeline the EventSim runtime uses
        obs.trace.set_track(f"sampler-{s.sid}")
        try:
            next_sync = self._now_s() + s.next_delay()
            while not self._stop.is_set():
                with self._lock:
                    bid, self._next_id = self._next_id, self._next_id + 1
                if self._do("gen", s.sid, self._now_s(), bid) is None:
                    continue              # stopped
                try:
                    self.queue.put(bid, timeout=1.0)
                except queue.Full:        # drop under backpressure
                    with self._lock:
                        self._pending.pop(bid, None)
                        if self._mesh is not None:
                            self._dropped.append(bid)
                if self._now_s() >= next_sync:
                    moved = self._do("sync", s.sid) or 0
                    next_sync = self._now_s() + s.next_delay(moved)
        except BaseException as e:      # surfaced by run()
            with self._lock:
                self.errors.append(e)

    def sync_telemetry(self):
        """Per-sampler link telemetry + learner publish accounting (the
        shape of HeteroRuntime.sync_telemetry)."""
        return link_telemetry(self.samplers, self.learner)

    def _next_batch(self, starve_s: float) -> int:
        """The next queued batch id; raises when a sampler thread failed
        or none arrived for ``starve_s`` wall seconds."""
        deadline = time.monotonic() + starve_s
        while True:
            if self.errors:
                raise RuntimeError("a sampler thread failed") \
                    from self.errors[0]
            try:
                return self.queue.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() >= deadline:
                    raise RuntimeError("samplers starved the learner")

    def _follow(self) -> MetricsHistory:
        """A follower's run: rank 0's sections, in its order, to its
        "stop"."""
        while True:
            op, args, forget = broadcast_object(None, self._mesh)
            with self._lock:
                for bid in forget:
                    self._pending.pop(bid, None)
            if op == "stop":
                return self.learner.history
            self._apply(op, args)

    def run(self, num_learner_steps: int) -> MetricsHistory:
        obs.trace.set_track("learner")
        if not self.leader:
            return self._follow()
        with self._lock:
            self.threads = [threading.Thread(target=self._sampler_loop,
                                             args=(s,), daemon=True)
                            for s in self.samplers]
        for t in self.threads:
            t.start()
        try:
            while self.learner.step < num_learner_steps:
                self._do("learn", self._next_batch(starve_s=30.0),
                         self._now_s())
        finally:
            self._stop.set()
            for t in self.threads:
                t.join(timeout=10.0)
            if self._mesh is not None:    # after every section: stop
                with self._section:
                    broadcast_object(("stop", (), []), self._mesh)
        if self.errors:
            raise RuntimeError("a sampler thread failed") from self.errors[0]
        return self.learner.history
