"""One rank of the static-engine plan jobs (run as a script, one process a
rank, by ``_torch_parallel_ranks.run_job``, which
``tests/test_torch_static_plan.py`` and ``tests/test_torch_family_plan.py``
call).

    python tests/_torch_static_ranks.py RANK WORLD STORE_FILE WORKDIR

Joins a gloo group of WORLD ranks through a ``file://`` store (60 s
timeout, one torch thread), reads the models' weights from
``WORKDIR/inputs.npz`` and the cases from ``WORKDIR/cases.json``, and
runs each case on its ``serve`` or ``long`` plan: the ``StaticEngine``
(``kind`` "static"), the legacy ``generate`` ("generate"), ``token_logps``
("logps"), or the static engine with the ranks' partial softmaxes summed
without their max rescale ("control"), with each rank's Mamba2 scan on
the next rank's heads ("ssm_control") or with each rank running the next
rank's experts ("control_experts"); a ``forward`` of the rank's rows of a
batch ("forward"), or one MoE layer on them ("moe_layer"), with its
router metrics. A case with ``moe_ep`` runs its MoE layers through
``models/moe_ep.py`` (``moe_ep="serve"``); a MoE case (``drops``) also
runs one device's static engine in the rank and records the
``moe_drop_frac`` of every MoE forward of both runs. A memory model's
memory is the case's input (patch embeddings), or the plan's ``encode``
of its frames (an encoder-decoder model). It writes, per rank,
``WORKDIR/out_<rank>.npz``: each case's tokens, log-probs and lengths (or
recomputed log-probs, or outputs), the shape of every leaf of the dense
cache the rank holds and the element count of every param leaf. Imports
torch and the port only.
"""
import dataclasses
import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_parallel_ranks import _leaves_with_paths, _unflatten  # noqa: E402
from _torch_serve_ranks import (DROPS, _record_drops,  # noqa: E402
                                _wrong_experts)


def _config(spec):
    from repro_torch.config import ModelConfig
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in spec.items()})


def _params(inputs, prefix):
    from repro_torch.models import params_from_numpy
    pre = prefix + "/"
    return params_from_numpy(_unflatten(
        {k[len(pre):]: inputs[k] for k in inputs.files
         if k.startswith(pre)}), device="cpu")


def _unscaled_combine(self, o, m, l, axes_):
    """The control: each rank's partial weighted by its sum alone, not by
    l exp(m - max over ranks)."""
    if not axes_:
        return o
    packed = torch.cat([o, l[..., None]], dim=-1)
    parts = self.gather(packed[None], axes_, 0)
    o_r, l_r = parts[..., :-1], parts[..., -1]
    return (o_r * l_r[..., None]).sum(dim=0) / l_r.sum(dim=0)[..., None]


def _wrong_ssm_heads(serve_shard):
    """The Mamba2 control: each rank scans the next rank's SSM heads of
    the gathered activations with its own parameters and state."""
    import dataclasses

    def wrong(plan, cfg):
        shard = serve_shard(plan, cfg)
        h0, hn = shard.ssm.heads
        return dataclasses.replace(shard, ssm=dataclasses.replace(
            shard.ssm, heads=((h0 + hn) % cfg.ssm_heads, hn)))
    return wrong


def _memory(case, cfg, params, plan, inputs):
    """The case's memory on every rank: its patch embeddings, or the
    plan's encoder over its frames."""
    from repro_torch import runtime_context
    from repro_torch.models import encode
    if not case.get("memory"):
        return None
    x = torch.from_numpy(inputs[case["memory"]])
    if not cfg.is_encdec:
        return x
    with torch.no_grad(), runtime_context.serve_context(
            plan.serve_shard(cfg)):
        return encode(cfg, plan.adopt_params(cfg, params), x)


def _run(case, cfg, params, plan, inputs, out):
    from repro_torch import runtime_context
    from repro_torch.config import RLConfig
    from repro_torch.models import init_cache
    from repro_torch.parallel import plan as plan_mod
    from repro_torch.sampling import StaticEngine, generate, token_logps
    from repro_torch.sampling.prng import PRNGKey
    from repro_torch.serving.api import Request, SamplingParams
    name = case["name"]
    memory = _memory(case, cfg, params, plan, inputs)
    if case["kind"] in ("forward", "moe_layer"):
        _rows_case(case, cfg, params, plan, inputs, out)
        return
    if case["kind"] == "logps":
        toks = torch.from_numpy(inputs[case["prompts"]]).long()
        lp = token_logps(cfg, plan.adopt_params(cfg, params), toks,
                         memory=memory, plan=plan)
        out[f"{name}/lp"] = lp.numpy()
        return
    prompts = inputs[case["prompts"]]
    new = case["max_new"]
    rl = RLConfig(temperature=1.0, top_k=0, top_p=1.0, max_new_tokens=new)
    key = PRNGKey(case["key"])
    if case["kind"] == "generate":
        roll = generate(cfg, rl, params, prompts, key, max_new=new,
                        vocab_limit=case["vocab_limit"], memory=memory,
                        engine="static", plan=plan)
        mask = roll["comp_mask"].numpy() > 0
        out[f"{name}/tokens"] = roll["completions"].numpy()[mask].astype(
            np.int64)
        out[f"{name}/logps"] = roll["sampler_lp"].numpy()[mask]
        out[f"{name}/lengths"] = mask.sum(1)
        return
    combine, serve_shard = plan_mod.ServeShard.combine, plan_mod._serve_shard
    if case["kind"] == "control":
        plan_mod.ServeShard.combine = _unscaled_combine
    if case["kind"] == "ssm_control":
        plan_mod._serve_shard = _wrong_ssm_heads(serve_shard)
    if case["kind"] == "control_experts":
        plan_mod._serve_shard = _wrong_experts(serve_shard)
    sp = SamplingParams(temperature=1.0, top_k=0, top_p=1.0,
                        max_new_tokens=new)

    def generate_on(plan):
        eng = StaticEngine(cfg, params, rl=rl,
                           vocab_limit=case["vocab_limit"], memory=memory,
                           key=key, plan=plan)
        return eng, eng.generate([Request(rid=i, prompt=p, params=sp)
                                  for i, p in enumerate(prompts)])
    DROPS.clear()
    try:
        eng, res = generate_on(plan)
    finally:
        plan_mod.ServeShard.combine = combine
        plan_mod._serve_shard = serve_shard
    if case.get("drops"):                 # the plan's, then one device's
        out[f"{name}/drops"] = np.array(DROPS)
        DROPS.clear()
        generate_on(None)
        out[f"{name}/drops_one"] = np.array(DROPS)
    for path, leaf in _leaves_with_paths(eng.params):
        out[f"{name}/numel/params/{path}"] = np.array(leaf.numel())
    out[f"{name}/tokens"] = np.concatenate(
        [r.tokens for r in res]).astype(np.int64)
    out[f"{name}/logps"] = np.concatenate([r.logps for r in res]).astype(
        np.float32)
    out[f"{name}/lengths"] = np.array([r.gen_count for r in res])
    # the dense cache this rank holds for the case's batch
    b, tp = prompts.shape
    shard = eng.shard.with_cache(tp + new, 0 if memory is None
                                 else memory.shape[1])
    _, r0, rn = shard.row_span(b)
    with torch.no_grad(), runtime_context.serve_context(shard):
        cache = init_cache(cfg, eng.params, rn, tp + new,
                           memory=None if memory is None
                           else memory[r0:r0 + rn])
    for path, leaf in _leaves_with_paths(cache):
        out[f"{name}/cache/{path}"] = np.array(leaf.shape)


def _rows_case(case, cfg, params, plan, inputs, out):
    """The rank's rows of a batch (its ``row_span``) through ``forward``
    ("forward": the logits) or through the MoE of layer slot 0, block 0
    ("moe_layer": its output), under its shard; the router metrics."""
    from repro_torch import runtime_context
    from repro_torch.models import forward
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.moe_ep import moe_ffn_ep
    name = case["name"]
    x = torch.from_numpy(inputs[case["prompts"]])
    placed = plan.adopt_params(cfg, params)
    shard = plan.serve_shard(cfg)
    ax, r0, rn = shard.row_span(x.shape[0])
    with torch.no_grad(), runtime_context.serve_context(
            shard.with_held_rows(ax)):
        if case["kind"] == "forward":
            y, _, aux = forward(cfg, placed, x[r0:r0 + rn].long())
        else:
            p = {k: (v[0] if torch.is_tensor(v) else
                     {n: t[0] for n, t in v.items()})
                 for k, v in placed["blocks"]["layer_0"]["moe"].items()}
            ffn = moe_ffn if cfg.moe_ep is None else moe_ffn_ep
            y, aux = ffn(cfg, p, x[r0:r0 + rn])
    out[f"{name}/y"] = y.numpy()
    out[f"{name}/rows"] = np.array([r0, rn])
    for k, v in aux.items():
        out[f"{name}/metric/{k}"] = np.array(float(v))


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
    _record_drops()
    meshes, out = {}, {}
    for dims in spec["meshes"]:               # every rank builds in order
        meshes[tuple(dims)] = make_mesh(tuple(dims), ("data", "model"),
                                        device="cpu")
    for case in spec["cases"]:
        plan = ExecutionPlan(meshes[tuple(case["mesh"])], case["mode"])
        cfg = _config(spec["models"][case["model"]])
        if case.get("moe_ep"):
            cfg = dataclasses.replace(cfg, moe_ep="serve",
                                      ep_dp_axes=plan.dp_axes)
        _run(case, cfg, _params(inputs, case["model"]), plan, inputs, out)
    np.savez(os.path.join(work, f"out_{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
