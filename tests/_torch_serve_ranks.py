"""One rank of the tensor-parallel serving jobs (run as a script, one
process a rank, by ``_torch_parallel_ranks.run_job``, which
``tests/test_torch_serve_plan.py`` calls).

    python tests/_torch_serve_ranks.py RANK WORLD STORE_FILE WORKDIR

Joins a gloo group of WORLD ranks through a ``file://`` store (60 s
timeout, one torch thread), reads the models' weights from
``WORKDIR/inputs.npz`` and the cases from ``WORKDIR/cases.json``, and
runs each case on its ``serve`` or ``long`` plan (``mode``, default
``serve``): ``generate_continuous`` ("generate"), the engine itself
("engine", "spec", "prefix"), the static engine ("static"), the engine
with each rank running the next
rank's experts ("control_experts"), or the threaded runtime on a 1x2
sampler plan ("threads"). A MoE case (``drops``) also runs one device's
engine in the rank and records the ``moe_drop_frac`` of every MoE
forward of both runs. It writes, per rank, ``WORKDIR/out_<rank>.npz``:
each case's tokens and log-probs, the element count and device of every
param and pool leaf the rank holds, and what the case records besides.
Imports torch and the port only.
"""
import dataclasses
import datetime
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_parallel_ranks import _leaves_with_paths, _unflatten  # noqa: E402


def _config(spec):
    from repro_torch.config import ModelConfig
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in spec.items()})


def _results(res):
    """(tokens, logps, lengths) of a list of GenerationResults."""
    return (np.concatenate([r.tokens for r in res]).astype(np.int64),
            np.concatenate([r.logps for r in res]).astype(np.float32),
            np.array([r.gen_count for r in res]))


DROPS = []                  # moe_drop_frac of each MoE forward, in order


def _record_drops():
    """Route models/moe.py's dispatch through a recorder of its drop
    fraction (every MoE layer of every forward appends one)."""
    from repro_torch.models import moe
    inner = moe._moe_ffn

    def recorded(cfg, p, x, tp=None):
        y, aux = inner(cfg, p, x, tp)
        DROPS.append(float(aux["moe_drop_frac"]))
        return y, aux
    moe._moe_ffn = recorded


def _wrong_experts(serve_shard):
    """The MoE control: each rank runs the next rank's experts (its own
    weights on another expert's dispatched rows)."""
    def wrong(plan, cfg):
        shard = serve_shard(plan, cfg)
        e0, en = shard.experts
        return dataclasses.replace(
            shard, experts=((e0 + en) % cfg.num_experts, en))
    return wrong


def _drive(case, cfg, params, plan, inputs, out):
    """Run one case's traffic on ``plan`` (None: one device, the local
    plan); returns the engine used, if any."""
    from repro_torch.config import RLConfig
    from repro_torch.sampling import StaticEngine, generate_continuous
    from repro_torch.sampling.continuous import ContinuousEngine
    from repro_torch.sampling.prng import PRNGKey
    from repro_torch.serving.api import Request, SamplingParams
    kw = case["engine"]
    rl = RLConfig(temperature=1.0, top_k=0, top_p=1.0,
                  max_new_tokens=kw["max_new"])
    prompts = inputs[case["prompts"]]
    key = PRNGKey(case["key"])
    if case["kind"] == "generate":
        roll = generate_continuous(
            cfg, rl, params, prompts, key, max_new=kw["max_new"],
            vocab_limit=kw["vocab_limit"], num_slots=kw["num_slots"],
            page_size=kw["page_size"], prefill_chunk=kw["prefill_chunk"],
            sync_every=kw["sync_every"], plan=plan)
        mask = roll["comp_mask"].numpy() > 0
        return None, (roll["completions"].numpy()[mask].astype(np.int64),
                      roll["sampler_lp"].numpy()[mask], mask.sum(1))
    sp = SamplingParams(temperature=1.0, top_k=0, top_p=1.0,
                        max_new_tokens=kw["max_new"])
    if case["kind"] == "static":
        eng = StaticEngine(cfg, params, rl=rl,
                           vocab_limit=kw["vocab_limit"], key=key, plan=plan)
        return eng, _results(eng.generate(
            [Request(rid=i, prompt=p, params=sp)
             for i, p in enumerate(prompts)]))
    eng = ContinuousEngine(
        cfg, params, rl=rl, max_total_tokens=prompts.shape[1]
        + kw["max_new"], num_slots=kw["num_slots"],
        page_size=kw["page_size"], sync_every=kw["sync_every"],
        prefill_chunk=kw["prefill_chunk"], vocab_limit=kw["vocab_limit"],
        prefix_cache=case["kind"] == "prefix", spec_k=kw.get("spec_k", 0),
        key=key, plan=plan)
    reqs = [Request(rid=i, prompt=p, params=sp)
            for i, p in enumerate(prompts)]
    if case["kind"] in ("spec", "engine", "control_experts"):
        return eng, _results(eng.generate(reqs))
    # prefix: request 0 alone until its prompt is cached, then request 1,
    # which shares its first tokens, into the other slot
    eng.submit(reqs[0])
    for _ in range(case["steps_before"]):
        eng.step(now_s=0.0)
    eng.submit(reqs[1])
    eng.step(now_s=0.0)
    second = eng.sched.slots[1]
    out[f"{case['name']}/second_slot"] = np.array(
        -1 if second is None or second.rid != 1 else 1)
    while eng.has_work():
        eng.step(now_s=0.0)
    res = [eng.pop_result(0), eng.pop_result(1)]
    out[f"{case['name']}/prefix_hits"] = np.array(
        [r.prefix_hit_tokens for r in res])
    return eng, _results(res)


def _node_case(case, cfg, params, plans, inputs, out):
    """A SamplerNode on the 1x2 serve plan syncs a version a 2x1 learner
    plan (``train_fsdp``: the weights' fan-out dims cut over 'data')
    published, fetching only its rank's cells, then re-fits onto the 2x1
    serve plan with a newer version; its batches against a one-device
    node's."""
    from repro_torch.checkpoint import PolicyStore
    from repro_torch.config import HeteroConfig, RLConfig
    from repro_torch.data import ArithmeticTask, PromptPipeline, Tokenizer
    from repro_torch.hetero import SamplerNode
    from repro_torch.parallel import local_plan
    from repro_torch.transport import publish_params
    from repro_torch.transport.manifest import Manifest
    name = case["name"]
    learner = plans[("train_fsdp", (2, 1))]
    serve, refit = plans[("serve", (1, 2))], plans[("serve", (2, 1))]
    rl = RLConfig(loss_type="gepo", group_size=4, max_new_tokens=4,
                  temperature=1.0, top_k=0, top_p=1.0, engine="continuous")
    tok = Tokenizer()
    store = PolicyStore()
    new = {v: _unflatten_params(inputs, f"{case['model']}_{v}")
           for v in ("v1", "v2")}

    def node(plan, store):                # its own prompt stream
        task = ArithmeticTask(max_operand=20, ops="+", prompt_width=6,
                              seed=0)
        return SamplerNode(0, cfg, rl, PromptPipeline(task, tok, 2, 4), task,
                           tok, params, store, HeteroConfig(), seed=3,
                           device="cpu", plan=plan)
    sharded = node(serve, store)
    publish_params(store, 1, learner, cfg,
                   learner.device_put_params(cfg, new["v1"]))
    sharded.sync()
    sub = sharded.subscriber
    manifest = Manifest.from_json(store.fetch(1)[1])
    need = sub.needed_refs(manifest, plan=serve, cfg=cfg,
                           devices=[serve.mesh.rank])
    out[f"{name}/fetched"] = np.array([
        sub.chunks_fetched, len({r.hash for _, refs in need for r in refs}),
        len({r.hash for lm in manifest.leaves for r in lm.chunks})])
    want = serve.local_shards(cfg, new["v1"])
    out[f"{name}/v1_equal"] = np.array(all(
        torch.equal(a, b) for (_, a), (_, b) in zip(
            _leaves_with_paths(sharded.params), _leaves_with_paths(want))))
    one = node(local_plan("serve", "cpu"), PolicyStore())
    one.load_params(new["v1"], 1)
    got, ref = sharded.generate_batch(0.0), one.generate_batch(0.0)
    out[f"{name}/batch_tokens"] = np.stack([got.tokens, ref.tokens])
    out[f"{name}/batch_lp"] = np.stack([got.sampler_lp, ref.sampler_lp])
    # re-fit onto the 2x1 serve plan with a newer version
    publish_params(store, 2, learner, cfg,
                   learner.device_put_params(cfg, new["v2"]))
    sharded.sync(plan=refit)
    one.load_params(new["v2"], 2)
    out[f"{name}/refit"] = np.array([sharded.plan == refit,
                                     sharded.version == 2])
    out[f"{name}/v2_equal"] = np.array(all(
        torch.equal(a, b) for (_, a), (_, b) in zip(
            _leaves_with_paths(sharded.params),
            _leaves_with_paths(new["v2"]))))
    got, ref = sharded.generate_batch(1.0), one.generate_batch(1.0)
    out[f"{name}/refit_tokens"] = np.stack([got.tokens, ref.tokens])
    out[f"{name}/refit_lp"] = np.stack([got.sampler_lp, ref.sampler_lp])


def _refusals(cfg, params, plans, out):
    """What a 1x2 serve plan serves, beside the traffic cases. The static
    engine (``build_engine`` and the legacy ``generate``), a ``long``
    plan's static and continuous engines, the front door, a static-engine
    ``SamplerNode``, the SSM, memory and MoE families serve: every rank
    returns the one-device run's tokens (the door is built and its engine
    is the plan's); the threaded runtime runs its steps on the sampler
    plan. A q head cut over the ranks and SSM heads cut apart from their
    channels serve too (the "head_split" and "ssm_split" cases)."""
    from repro_torch.config import (HeteroConfig, RLConfig, ServeConfig,
                                    TrainConfig)
    from repro_torch.configs import smoke
    from repro_torch.data import ArithmeticTask, Tokenizer
    from repro_torch.hetero import ThreadedHeteroRuntime
    from repro_torch.models import init_params
    from repro_torch.parallel import ExecutionPlan
    from repro_torch.sampling import StaticEngine, build_engine, generate
    from repro_torch.sampling.prng import PRNGKey
    from repro_torch.serving.api import Request, SamplingParams
    from repro_torch.serving.server import FrontDoor
    from repro_torch.training import init_state
    serve = plans[("serve", (1, 2))]
    long = ExecutionPlan(serve.mesh, "long")
    rl = RLConfig(temperature=1.0, top_k=0, top_p=1.0, max_new_tokens=4)
    sp = SamplingParams.from_rl(rl)
    prompts = np.arange(3, 27).reshape(4, 6) % 29 + 3

    def static(c, p, plan, memory=None):
        eng = build_engine(c, p, ServeConfig(engine="static"), rl=rl,
                           memory=memory, key=PRNGKey(7), plan=plan)
        got = eng.generate([Request(rid=i, prompt=q, params=sp)
                            for i, q in enumerate(prompts)])
        one = StaticEngine(c, p, rl=rl, memory=memory, key=PRNGKey(7))
        want = one.generate([Request(rid=i, prompt=q, params=sp)
                             for i, q in enumerate(prompts)])
        return isinstance(eng, StaticEngine) and all(
            np.array_equal(a.tokens, b.tokens) for a, b in zip(got, want))

    def continuous(c, p, plan):
        kw = dict(engine="continuous", num_slots=2, page_size=4,
                  prefill_chunk=3, sync_every=2)
        got = generate(c, rl, p, prompts, PRNGKey(7), plan=plan, **kw)
        want = generate(c, rl, p, prompts, PRNGKey(7), **kw)
        return torch.equal(got["tokens"], want["tokens"])

    def legacy():
        got = generate(cfg, rl, params, prompts, PRNGKey(7),
                       engine="static", plan=serve)["tokens"]
        want = generate(cfg, rl, params, prompts, PRNGKey(7),
                        engine="static")["tokens"]
        return torch.equal(got, want)

    def family(name, engine=static):
        c = smoke(name)
        p = init_params(c, 0, device="cpu")
        if engine is continuous:
            return continuous(c, p, serve)
        mem = None
        if c.memory_seq:
            mem = 0.02 * torch.randn((4, c.memory_seq, c.d_model),
                                     generator=torch.Generator().manual_seed(
                                         1))
        return static(c, p, serve, mem)

    def node():
        """A static-engine SamplerNode on the plan (the static engine and
        its recompute, ``token_logps(plan=)``) against one device's."""
        from repro_torch.checkpoint import PolicyStore
        from repro_torch.data import PromptPipeline
        from repro_torch.hetero import SamplerNode
        from repro_torch.parallel import local_plan
        nrl = RLConfig(loss_type="gepo", group_size=4, max_new_tokens=4,
                       temperature=1.0, top_k=0, top_p=1.0, engine="static")
        tok = Tokenizer()
        batches = []
        for plan in (serve, local_plan("serve", "cpu")):
            task = ArithmeticTask(max_operand=20, ops="+", prompt_width=6,
                                  seed=0)
            n = SamplerNode(0, cfg, nrl, PromptPipeline(task, tok, 2, 4),
                            task, tok, params, PolicyStore(), HeteroConfig(),
                            seed=3, device="cpu", plan=plan)
            batches.append(n.generate_batch(0.0))
        a, b = batches
        return (np.array_equal(a.tokens, b.tokens)
                and np.abs(a.sampler_lp - b.sampler_lp).max() <= 1e-5)

    def door():
        d = FrontDoor(cfg, params, ServeConfig(num_slots=2), rl=rl,
                      plan=serve)
        return d.engine.plan is serve and d.engine.shard is not None

    def threads():
        trl = RLConfig(loss_type="gepo", group_size=4, max_new_tokens=4,
                       temperature=1.0, top_k=0, top_p=1.0,
                       engine="continuous")
        tc = TrainConfig(learning_rate=1e-3, total_steps=50)
        rt = ThreadedHeteroRuntime(
            cfg, trl, tc, HeteroConfig(num_samplers=2, seed=7),
            ArithmeticTask(max_operand=9, ops="+", prompt_width=5, seed=7),
            Tokenizer(), init_state(cfg, tc, params), prompts_per_batch=2,
            time_scale=5e-3, device="cpu", sampler_plan=serve)
        rt.run(2)
        return rt.learner.step == 2

    serves = {
        "static": lambda: static(cfg, params, serve),
        "generate_static": legacy,
        "long": lambda: continuous(cfg, params, long),
        "moe": lambda: family("llama4-scout-17b-a16e", continuous),
        "threads": threads,
        "long_static": lambda: static(cfg, params, long),
        "door": door,
        "node_static": node,
        "ssm": lambda: family("mamba2-1.3b"),
        "memory": lambda: family("llama-3.2-vision-11b"),
    }
    for name, fn in serves.items():
        out[f"refuse/{name}"] = np.array(bool(fn()))


def _threads_case(case, cfg, params, plans, out):
    """``ThreadedHeteroRuntime.run`` on the 1x2 sampler plan (rank 0 runs
    the threads, rank 1 replays its sections): every batch a rank's
    samplers generate, in order, and the learner's staleness."""
    from repro_torch import training
    from repro_torch.config import HeteroConfig, RLConfig, TrainConfig
    from repro_torch.data import ArithmeticTask, Tokenizer
    from repro_torch.hetero import ThreadedHeteroRuntime
    name = case["name"]
    rl = RLConfig(loss_type="gepo", group_size=4, max_new_tokens=4,
                  beta_kl=0.005, temperature=1.0, top_k=0, top_p=1.0,
                  engine="continuous")
    tc = TrainConfig(learning_rate=1e-3, total_steps=50)
    task = ArithmeticTask(max_operand=9, ops="+", prompt_width=5, seed=7)
    hc = HeteroConfig(num_samplers=2, max_delay_steps=16,
                      delay_median_s=120.0, seed=7)
    rt = ThreadedHeteroRuntime(
        cfg, rl, tc, hc, task, Tokenizer(),
        training.init_state(cfg, tc, params), prompts_per_batch=4,
        time_scale=5e-3, device="cpu",
        sampler_plan=plans[("serve", (1, 2))])
    seen = []
    for s in rt.samplers:
        def recorded(now_s, gen=s.generate_batch):
            b = gen(now_s)
            seen.append(b)
            return b
        s.generate_batch = recorded
    t0 = time.monotonic()
    hist = rt.run(case["steps"])
    out[f"{name}/seconds"] = np.array(time.monotonic() - t0)
    out[f"{name}/leader"] = np.array(rt.leader)
    out[f"{name}/steps"] = np.array(rt.learner.step)
    out[f"{name}/batch_meta"] = np.array(
        [[b.sampler_id, b.version] for b in seen])
    out[f"{name}/batch_tokens"] = np.stack([b.tokens for b in seen])
    out[f"{name}/batch_lp"] = np.stack([b.sampler_lp for b in seen])
    for key in ("staleness", "loss", "kl", "iw_var"):
        out[f"{name}/{key}"] = hist.get(key)


def _unflatten_params(inputs, prefix):
    from repro_torch.models import params_from_numpy
    pre = prefix + "/"
    return params_from_numpy(_unflatten(
        {k[len(pre):]: inputs[k] for k in inputs.files
         if k.startswith(pre)}), device="cpu")


def main():
    rank, world, store, work = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    from repro_torch.parallel import ExecutionPlan, make_mesh
    inputs = np.load(os.path.join(work, "inputs.npz"))
    with open(os.path.join(work, "cases.json")) as f:
        spec = json.load(f)
    meshes, plans, out = {}, {}, {}
    for dims in spec["meshes"]:               # every rank builds in order
        meshes[tuple(dims)] = make_mesh(tuple(dims), ("data", "model"),
                                        device="cpu")
    _record_drops()
    for mode in ("serve", "long", "train_fsdp"):
        for dims, mesh in meshes.items():
            plans[(mode, dims)] = ExecutionPlan(mesh, mode)
    for case in spec["cases"]:
        name = case["name"]
        cfg = _config(spec["models"][case["model"]])
        if case.get("impl"):
            cfg = dataclasses.replace(cfg, paged_attn_impl=case["impl"])
        params = _unflatten_params(inputs, case["model"])
        if case["kind"] == "node":
            _node_case(case, cfg, params, plans, inputs, out)
            _refusals(cfg, params, plans, out)
            continue
        if case["kind"] == "threads":
            _threads_case(case, cfg, params, plans, out)
            continue
        plan = plans[(case.get("mode", "serve"), tuple(case["mesh"]))]
        from repro_torch.parallel import plan as plan_mod
        serve_shard = plan_mod._serve_shard
        if case["kind"] == "control_experts":
            plan_mod._serve_shard = _wrong_experts(serve_shard)
        DROPS.clear()
        try:
            eng, (toks, lps, lens) = _drive(case, cfg, params, plan, inputs,
                                            out)
        finally:
            plan_mod._serve_shard = serve_shard
        if case.get("drops"):             # the plan's, then one device's
            out[f"{name}/drops"] = np.array(DROPS)
            DROPS.clear()
            _drive(case, cfg, params, None, inputs, out)
            out[f"{name}/drops_one"] = np.array(DROPS)
        out[f"{name}/tokens"], out[f"{name}/logps"] = toks, lps
        out[f"{name}/lengths"] = lens
        if eng is not None:
            for key, leaf in _leaves_with_paths(eng.params):
                out[f"{name}/numel/params/{key}"] = np.array(
                    [leaf.numel(), leaf.device.type == "cpu"])
            for key, leaf in _leaves_with_paths(getattr(eng, "pool", {})):
                out[f"{name}/numel/pool/{key}"] = np.array(
                    [leaf.numel(), leaf.device.type == "cpu"])
            if case["kind"] == "spec":
                st = eng.stats()
                out[f"{name}/spec"] = np.array(
                    [st["spec_rounds"], st["drafted_tokens_total"],
                     st["spec_rescore_max_diff"]])
    np.savez(os.path.join(work, f"out_{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
