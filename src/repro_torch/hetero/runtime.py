"""HeteroRL orchestration: the port of ``repro/hetero/runtime.py``.

``HeteroRuntime`` wires one learner + N samplers (star topology) into the
discrete-event simulation: samplers generate continuously and sync models
after WAN delays D_M ~ P_d; the learner trains on arriving batches inside
its staleness window. ``run_online`` is the synchronous (delay-0) control
used for Table 1.

Time model (defaults follow the paper's scale): one learner step costs
``learner_step_s`` simulated seconds; the paper's 1800 s max delay then
corresponds to 1800/28.125 = 64 learner steps — the "Max Tolerable
Delay 64" setting of Table 2. Every node runs on ``device`` (default
``cuda``), each with its own copy of the weights; the learner on
``learner_plan`` (default the ``TrainConfig.mesh`` knob), the samplers on
``sampler_plan`` (default the ``HeteroConfig.sampler_mesh`` knob). The
event clock is deterministic, so on live plans every rank runs the same
events in the same order and meets each node's collectives in step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from repro_torch import obs
from repro_torch.checkpoint import PolicyStore
from repro_torch.config import HeteroConfig, ModelConfig, RLConfig, TrainConfig
from repro_torch.core.diagnostics import MetricsHistory
from repro_torch.data import ArithmeticTask, PromptPipeline, Tokenizer
from repro_torch.device import DeviceLike
from repro_torch.hetero.events import EventSim, Transport
from repro_torch.hetero.nodes import (LearnerNode, RolloutBatch, SamplerNode,
                                      link_telemetry)
from repro_torch.parallel import ExecutionPlan
from repro_torch.training import TrainState


class HeteroRuntime:
    def __init__(self, cfg: ModelConfig, rl: RLConfig, tc: TrainConfig,
                 hcfg: HeteroConfig, task: ArithmeticTask, tok: Tokenizer,
                 state: TrainState, *, prompts_per_batch: int = 8,
                 learner_step_s: float = 28.125,
                 sampler_gen_s: Optional[float] = None,
                 eval_fn: Optional[Callable[[Any], float]] = None,
                 eval_every: int = 10,
                 device: DeviceLike = "cuda",
                 learner_plan: Optional[ExecutionPlan] = None,
                 sampler_plan: Optional[ExecutionPlan] = None) -> None:
        self.cfg, self.rl, self.tc, self.hcfg = cfg, rl, tc, hcfg
        self.task, self.tok = task, tok
        self.learner_step_s = learner_step_s
        # keep producer/consumer rates balanced by default
        self.sampler_gen_s = (sampler_gen_s if sampler_gen_s is not None
                              else learner_step_s * hcfg.num_samplers)
        self.eval_fn, self.eval_every = eval_fn, eval_every
        self.eval_scores: List[float] = []

        self.sim = EventSim()
        # observability rides the virtual clock: spans recorded during
        # this run carry simulated seconds (enable obs before building
        # the runtime, or re-point the clock later via obs.configure)
        if obs.trace.enabled:
            obs.trace.use_sim(self.sim)
        self.transport = Transport(self.sim)
        self.store = PolicyStore()
        self.learner = LearnerNode(cfg, rl, tc, hcfg, state, self.store,
                                   device=device, plan=learner_plan)
        weights = self.learner.full_params()
        self.samplers = [
            SamplerNode(i, cfg, rl,
                        PromptPipeline(task, tok, prompts_per_batch,
                                       rl.group_size),
                        task, tok, weights, self.store,
                        hcfg, seed=hcfg.seed * 1000 + i,
                        logprob_impl=tc.logprob_impl, device=device,
                        plan=sampler_plan)
            for i in range(hcfg.num_samplers)
        ]
        self._learner_busy = False
        self._target_steps = 0

    # ---- event handlers --------------------------------------------------
    def _sampler_gen_done(self, s: SamplerNode) -> None:
        batch = s.generate_batch(self.sim.now)
        # the generation occupied the simulated window ending now — an
        # explicitly-timed span, since sim.now doesn't advance inside
        # the handler (the node's own spans are zero-width markers here)
        obs.trace.complete("gen_window",
                           max(self.sim.now - self.sampler_gen_s, 0.0),
                           self.sim.now, track=f"sampler-{s.sid}",
                           version=batch.version)
        # data transfer is folded into the model-sync delay (App. E.1)
        self.transport.send(0.0,
                            lambda b=batch: self._deliver(b),
                            nbytes=batch.nbytes())
        self.sim.schedule(self.sampler_gen_s,
                          lambda s=s: self._sampler_gen_done(s))

    def _sampler_sync(self, s: SamplerNode) -> None:
        # payload-aware D_M: the bytes this sync moved (manifest + missing
        # chunks) charge serialization time on the *next* sync gap
        moved = s.sync()
        self.sim.schedule(s.next_delay(moved),
                          lambda s=s: self._sampler_sync(s))

    def _deliver(self, batch: RolloutBatch) -> None:
        self.learner.receive(self.sim.now, batch)
        self._maybe_start_step()

    def _maybe_start_step(self) -> None:
        if self._learner_busy or self.learner.step >= self._target_steps:
            return
        batch = self.learner.pop_eligible(self.sim.now)
        if batch is None:
            return
        self._learner_busy = True
        self.sim.schedule(self.learner_step_s,
                          lambda b=batch: self._finish_step(b))

    def _finish_step(self, batch: RolloutBatch) -> None:
        self.learner.train_on(batch)
        # the step occupied the simulated window [now - step_s, now]
        obs.trace.complete("step_window",
                           max(self.sim.now - self.learner_step_s, 0.0),
                           self.sim.now, track="learner",
                           step=self.learner.step,
                           staleness=self.learner.step - 1 - batch.version)
        self._learner_busy = False
        if (self.eval_fn is not None
                and self.learner.step % self.eval_every == 0):
            score = self.eval_fn(self.learner.full_params())
            self.eval_scores.append(score)
            self.learner.history.append(self.learner.step,
                                        {"eval_score": score})
        self._maybe_start_step()

    def sync_telemetry(self) -> List[Dict[str, float]]:
        """Per-sampler weight-transport telemetry (bytes on wire, dedup
        ratio, simulated sync seconds) plus the learner's publish-side
        stream accounting."""
        return link_telemetry(self.samplers, self.learner)

    # ---- drivers ----------------------------------------------------------
    def run(self, num_learner_steps: int) -> MetricsHistory:
        self._target_steps = num_learner_steps
        for s in self.samplers:
            self.sim.schedule(self.sampler_gen_s / max(len(self.samplers), 1)
                              * s.sid, lambda s=s: self._sampler_gen_done(s))
            self.sim.schedule(s.next_delay(),
                              lambda s=s: self._sampler_sync(s))
        self.sim.run_until(stop=lambda: self.learner.step
                           >= num_learner_steps)
        return self.learner.history


def run_online(cfg: ModelConfig, rl: RLConfig, tc: TrainConfig,
               task: ArithmeticTask, tok: Tokenizer, state: TrainState, *,
               num_steps: int, prompts_per_batch: int = 8, seed: int = 0,
               eval_fn: Optional[Callable[[Any], float]] = None,
               eval_every: int = 10, device: DeviceLike = "cuda",
               learner_plan: Optional[ExecutionPlan] = None,
               sampler_plan: Optional[ExecutionPlan] = None):
    """Synchronous on-policy RL (Max Tolerable Delay 0, Table 1): the
    sampler always holds the learner's current parameters. The learner
    runs on ``learner_plan`` (default the ``TrainConfig.mesh`` knob), the
    sampler on ``sampler_plan`` (default the local plan on ``device``)."""
    hcfg = HeteroConfig(num_samplers=1, max_delay_steps=0,
                        delay_distribution="constant", delay_min_s=0.0,
                        delay_median_s=0.0, seed=seed)
    store = PolicyStore()
    learner = LearnerNode(cfg, rl, tc, hcfg, state, store, device=device,
                          plan=learner_plan)
    pipeline = PromptPipeline(task, tok, prompts_per_batch, rl.group_size)
    sampler = SamplerNode(0, cfg, rl, pipeline, task, tok,
                          learner.full_params(), store, hcfg, seed=seed,
                          logprob_impl=tc.logprob_impl, device=device,
                          plan=sampler_plan)
    eval_scores: List[float] = []
    for step in range(num_steps):
        # strict synchrony: the learner's weights are copied into the
        # sampler's own tensors every step
        sampler.load_params(learner.full_params(), learner.step)
        batch = sampler.generate_batch(float(step))
        learner.receive(float(step), batch)
        b = learner.pop_eligible(float(step))
        learner.train_on(b)
        if eval_fn is not None and learner.step % eval_every == 0:
            score = eval_fn(learner.full_params())
            eval_scores.append(score)
            learner.history.append(learner.step, {"eval_score": score})
    return learner.history, eval_scores, learner
