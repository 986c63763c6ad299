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
``HeteroConfig.sampler_mesh`` knob); a live one raises
``NotImplementedError``: each thread's batches and syncs follow the wall
clock, so ranks would meet the samplers' collectives in different orders.
Run a sampler mesh under the event-clock ``HeteroRuntime``.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

from repro_torch import obs
from repro_torch.checkpoint import PolicyStore
from repro_torch.config import HeteroConfig, ModelConfig, RLConfig, TrainConfig
from repro_torch.core.diagnostics import MetricsHistory
from repro_torch.data import ArithmeticTask, PromptPipeline, Tokenizer
from repro_torch.device import DeviceLike
from repro_torch.hetero.nodes import (LearnerNode, RolloutBatch, SamplerNode,
                                      link_telemetry)
from repro_torch.parallel import ExecutionPlan, plan_from_flag
from repro_torch.parallel.plan import QUEUE_ITEM
from repro_torch.training import TrainState


class ThreadedHeteroRuntime:
    """One learner (the calling thread) and ``hcfg.num_samplers`` sampler
    threads. ``run`` joins each sampler thread for 10 s before it returns;
    ``threads`` keeps them, so a caller can wait for one that outlived the
    run (a batch still in flight)."""

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
        if sampler_plan.mesh.live:
            raise NotImplementedError(
                f"{sampler_plan.describe()}: sampler threads on a mesh reach "
                "their collectives in wall-clock order, which differs by "
                f"rank; run the sampler mesh under HeteroRuntime "
                f"({QUEUE_ITEM})")
        self.hcfg = hcfg
        self.time_scale = time_scale
        self.store = PolicyStore()
        self.learner = LearnerNode(cfg, rl, tc, hcfg, state, self.store,
                                   device=device, plan=learner_plan)
        self.queue: queue.Queue[RolloutBatch] = queue.Queue(queue_size)
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
        self._lock = threading.Lock()     # guards the three above
        self._stop = threading.Event()
        self._t0 = time.monotonic()

    # wall clock stands in for the virtual clock
    def _now_s(self) -> float:
        return (time.monotonic() - self._t0) / self.time_scale

    def _sampler_loop(self, s: SamplerNode) -> None:
        # this thread's trace track, so wall-clock spans land on the named
        # timeline the EventSim runtime uses
        obs.trace.set_track(f"sampler-{s.sid}")
        try:
            next_sync = self._now_s() + s.next_delay()
            while not self._stop.is_set():
                batch = s.generate_batch(self._now_s())
                try:
                    self.queue.put(batch, timeout=1.0)
                except queue.Full:
                    pass                  # drop under backpressure
                if self._now_s() >= next_sync:
                    # chunked delta sync; the bytes moved charge
                    # serialization time on the next sync gap
                    try:
                        moved = s.sync()
                    except KeyError:
                        # lost the publisher's prune race even after the
                        # node's retries: skip this round, the next
                        # interval syncs a newer version
                        moved = 0
                        with self._lock:
                            self.skipped_syncs += 1
                    next_sync = self._now_s() + s.next_delay(moved)
        except BaseException as e:      # surfaced by run()
            with self._lock:
                self.errors.append(e)

    def sync_telemetry(self):
        """Per-sampler link telemetry + learner publish accounting (the
        shape of HeteroRuntime.sync_telemetry)."""
        return link_telemetry(self.samplers, self.learner)

    def _next_batch(self, starve_s: float) -> RolloutBatch:
        """The next queued batch; raises when a sampler thread failed or
        none arrived for ``starve_s`` wall seconds."""
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

    def run(self, num_learner_steps: int) -> MetricsHistory:
        obs.trace.set_track("learner")
        with self._lock:
            self.threads = [threading.Thread(target=self._sampler_loop,
                                             args=(s,), daemon=True)
                            for s in self.samplers]
        for t in self.threads:
            t.start()
        try:
            while self.learner.step < num_learner_steps:
                batch = self._next_batch(starve_s=30.0)
                self.learner.receive(self._now_s(), batch)
                b = self.learner.pop_eligible(self._now_s())
                if b is not None:
                    self.learner.train_on(b)
        finally:
            self._stop.set()
            for t in self.threads:
                t.join(timeout=10.0)
        if self.errors:
            raise RuntimeError("a sampler thread failed") from self.errors[0]
        return self.learner.history
