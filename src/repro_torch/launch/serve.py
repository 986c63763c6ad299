"""Serving entry point: what a HeteroRL sampler node runs, on the port.

Builds a model with random weights from ``--seed``, the engine a
``ServeConfig`` describes (``--engine continuous``, the default here, or
``static``), and serves ``--rounds`` batches of seeded random prompts
through its ``generate`` (a key split from ``PRNGKey(--seed)`` per
round):

  PYTHONPATH=src python -m repro_torch.launch.serve               # qwen3-1.7b on cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve --engine static --attn-impl pallas
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b
  PYTHONPATH=src python -m repro_torch.launch.serve --spec-k 4

The static engine takes a rectangular batch, so its prompts all have
``--prompt-len`` tokens; the continuous engine's are drawn in
[len/4, len]. ``--attn-impl pallas`` runs the static engine's prefill
through the flash kernel K5. An architecture the paged cache cannot serve
(``mamba2-1.3b``) is served static under ``--engine continuous``, with a
warning. Its prefill fills a cache, so it runs the chunked SSD, and its
decode runs the recurrence: the SSD kernel K6 serves only the cache-free
recompute (``ModelConfig.ssd_impl``).

The modality-memory families serve static with a stub memory of one row
per request, drawn from a ``torch.Generator`` seeded by ``--seed``, as
the JAX package's launcher stubs it: ``llama-3.2-vision-11b`` cross-attends
to 0.02 N(0, 1) patch embeddings (``memory_seq`` of them), and
``whisper-small``'s decoder to ``encode`` over N(0, 1) frame embeddings
(``encoder_seq`` frames); ``--listen`` refuses both, since the front door
serves the continuous engine:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke --arch llama-3.2-vision-11b

``--spec-k K`` turns on speculative decoding in the continuous engine:
an n-gram drafter proposes up to K tokens a round, one forward verifies
them (``--spec-ngram``: the longest suffix n-gram matched;
``--no-spec-rescore`` skips the folded-layers rescore), and the summary
prints the engine's accept rate.

``--listen`` runs the asyncio front door instead
(``repro_torch.serving.server``: ``POST /generate``, ``GET /ws``,
``/healthz``, ``/metrics``) over the continuous engine, with admission
control (``--max-queue``, ``--deadline-s``) and the ``ArithmeticTask``
tokenizer, so ``{"text": ...}`` requests work; it prints the port it
listens on (``--port 0`` takes a free one) and runs until interrupted:

  PYTHONPATH=src python -m repro_torch.launch.serve --listen --port 8100
  PYTHONPATH=src python -m repro_torch.launch.serve --listen --device cpu --smoke
  curl -s localhost:8100/generate -d '{"text": "12+7=", "max_new_tokens": 4}'

``--smoke`` serves the reduced variant of ``--arch``.

``--mesh DxM`` serves on a ``serve`` ``ExecutionPlan`` (``ServeConfig.mesh``):
the continuous engine runs tensor-parallel over 'model' (each rank keeps
its heads, FFN columns and vocab rows of the weights and its KV heads of
the page pools) and splits the decode slots over 'data'; the static
engine (``--engine static``, and the SSM and memory families) keeps the
same shard of the weights and its span of the dense cache's positions
over 'model', its rows over 'data', and decodes context-parallel. A mesh
of more than one rank runs under ``torchrun``, one rank a process (NCCL
on ``cuda``, each rank on card ``LOCAL_RANK``; gloo on ``cpu``); every
rank serves the same rounds, and rank 0 prints the plan and the lines
below:

  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve \
      --device cpu --smoke --mesh 1x2
  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve \
      --mesh 1x2 --engine static
  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve \
      --mesh 1x2 --listen --port 8100

With ``--listen`` rank 0 runs the front door and the other ranks follow
its engine rounds (``FrontDoor.follow``). Every rank draws the full
weights from ``--seed`` and keeps its shard. The MoE family
(``--arch llama4-scout-17b-a16e``, ``llama4-maverick-400b-a17b``) keeps
its experts over 'model' and their FFN columns over 'data' and
dispatches every token at the global capacity; jamba
(``jamba-1.5-large-398b``) serves static, its Mamba2 layers on the
rank's SSM heads:

  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve \
      --device cpu --smoke --mesh 1x2 --arch llama4-scout-17b-a16e

A mesh whose 'model' axis cuts inside a q head (Qwen2-7B's 28 heads over
16 ranks), or cuts SSM channels finer than their heads, serves too: the
rank gathers the cut head's columns (``ServeShard.q_cols``) or keeps its
channels of its heads (``SsmSplit.inner``).

``--obs`` turns on the metrics registry and the span tracer
(``repro_torch.obs``; off by default, at no cost); ``--trace-out F``
(which implies ``--obs``) writes the tracer's events, the continuous
engine's prefill, decode and verify spans among them, as Chrome-trace /
Perfetto JSON to F on exit, in batch and front-door mode:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
      --trace-out /tmp/serve_trace.json
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import obs, runtime_context
from repro_torch.config import RLConfig, ServeConfig
from repro_torch.configs import get_config, smoke
from repro_torch.data import Tokenizer
from repro_torch.models import encode, init_params
from repro_torch.parallel import plan_from_flag
from repro_torch.sampling import StaticEngine, build_engine
from repro_torch.sampling.prng import PRNGKey, split
from repro_torch.serving.api import Request, SamplingParams


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced variant of --arch")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64,
                    help="longest prompt; lengths are drawn in [len/4, len]")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--attn-impl", default=None,
                    choices=("naive", "chunked", "pallas"),
                    help="full-sequence attention (ModelConfig.attn_impl; "
                         "default: the config's)")
    # ServeConfig fields ---------------------------------------------------
    ap.add_argument("--engine", choices=("static", "continuous"),
                    default="continuous")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prompt tokens prefilled per engine round "
                         "(0 = whole prompt in one chunk)")
    ap.add_argument("--sync-every", type=int, default=8)
    ap.add_argument("--max-total-tokens", type=int, default=0,
                    help="per-request prompt+completion cap "
                         "(0 = --prompt-len + --max-new)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="KV page-pool override (0 = full budget per slot)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable shared-prefix KV page reuse")
    ap.add_argument("--paged-attn-impl", default=None,
                    choices=("auto", "pallas", "ref", "gather"))
    ap.add_argument("--mesh", default="1x1",
                    help="serve mesh DxM (decode slots over data x tensor "
                         "parallel over model); more than one rank runs "
                         "under torchrun")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: drafts per verify round "
                         "(0 = off; continuous engine only)")
    ap.add_argument("--spec-ngram", type=int, default=3,
                    help="longest suffix n-gram the prompt-lookup "
                         "drafter matches")
    ap.add_argument("--no-spec-rescore", action="store_true",
                    help="skip the folded-layers rescore of each verify "
                         "round (one K4 launch a round)")
    # sampling profile -----------------------------------------------------
    ap.add_argument("--temperature", type=float, default=0.6)
    ap.add_argument("--top-k", type=int, default=20)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--seed", type=int, default=0)
    # front door -----------------------------------------------------------
    ap.add_argument("--listen", action="store_true",
                    help="run the HTTP/websocket front door instead of "
                         "batch rounds")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8100)
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="default TTFT deadline applied to front-door "
                         "requests (0 = none)")
    # observability --------------------------------------------------------
    ap.add_argument("--obs", action="store_true",
                    help="enable the unified metrics registry + span "
                         "tracer (off by default: zero-cost)")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome-trace/Perfetto JSON here on exit "
                         "(implies --obs)")
    return ap.parse_args(argv)


def parse_serve_config(args: argparse.Namespace) -> ServeConfig:
    """The single deployment object the loose flags collapse into."""
    return ServeConfig(
        engine=args.engine, num_slots=args.slots, page_size=args.page_size,
        prefill_chunk=args.prefill_chunk, sync_every=args.sync_every,
        max_total_tokens=args.max_total_tokens
        or args.prompt_len + args.max_new, num_pages=args.num_pages,
        prefix_cache=not args.no_prefix_cache,
        paged_attn_impl=args.paged_attn_impl, spec_k=args.spec_k,
        spec_ngram_max=args.spec_ngram,
        spec_rescore=not args.no_spec_rescore, host=args.host,
        port=args.port, max_queue=args.max_queue,
        default_deadline_s=args.deadline_s, seed=args.seed, mesh=args.mesh)


@torch.no_grad()
def stub_memory(cfg, params, batch: int, seed: int,
                plan=None) -> Optional[torch.Tensor]:
    """The stub memory of a memory or encoder-decoder model, one row per
    request (None for any other model): ``encode`` over N(0, 1) frame
    embeddings (batch, encoder_seq, d) for an encoder-decoder model,
    0.02 N(0, 1) patch embeddings (batch, memory_seq, d) for a CROSS
    model, in ``cfg.dtype``, from a generator seeded by ``seed``. On a
    live ``plan`` ``params`` are this rank's shards, and the encoder runs
    on the rank's heads (every rank the whole memory)."""
    if not (cfg.is_encdec or cfg.memory_seq):
        return None
    dev = params["embed"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = cfg.encoder_seq if cfg.is_encdec else cfg.memory_seq
    x = torch.randn((batch, rows, cfg.d_model), generator=gen, device=dev)
    if cfg.is_encdec:
        shard = None if plan is None else plan.serve_shard(cfg)
        with runtime_context.serve_context(shard):
            return encode(cfg, params, x.to(getattr(torch, cfg.dtype)))
    return (0.02 * x).to(getattr(torch, cfg.dtype))


def main(argv=None) -> None:
    args = parse_args(argv)
    device = args.device
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:                                # under torchrun
        import torch.distributed as dist
        if device == "cuda":
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    if args.obs or args.trace_out:
        obs.configure(True)
    try:
        _serve(args, device)
    finally:
        if world > 1:
            dist.destroy_process_group()
        if args.trace_out and int(os.environ.get("RANK", "0")) == 0:
            n = obs.export_chrome_trace(args.trace_out)
            print(f"[serve] wrote {n} trace events -> {args.trace_out}")


def _serve(args: argparse.Namespace, device: str) -> None:
    cfg = smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    serve = parse_serve_config(args)
    rl = RLConfig(temperature=args.temperature, top_k=args.top_k,
                  top_p=args.top_p, max_new_tokens=args.max_new,
                  engine=serve.engine)
    plan = plan_from_flag(serve.mesh, "serve", device)
    rank0 = plan.mesh.rank in (None, 0)
    if plan.mesh.live:
        plan.serve_shard(cfg)            # raises for what it cannot serve
        if rank0:
            print(f"[serve] {plan.describe()}")
    # every rank draws the full weights and keeps its shard
    params = plan.device_put_params(cfg, init_params(cfg, args.seed,
                                                     device=device))
    key = PRNGKey(serve.seed)
    memory = stub_memory(cfg, params, args.batch, args.seed, plan)
    if args.listen:
        if memory is not None:
            raise SystemExit("--listen serves decoder-only KV-cache "
                             "architectures (continuous engine)")
        from repro_torch.serving.server import serve_forever
        tok = Tokenizer()
        try:
            asyncio.run(serve_forever(cfg, params, serve, rl=rl,
                                      tokenizer=tok,
                                      vocab_limit=tok.vocab_size, key=key,
                                      plan=plan))
        except KeyboardInterrupt:
            pass
        return
    engine = build_engine(cfg, params, serve, rl=rl,
                          vocab_limit=cfg.vocab_size, memory=memory, key=key,
                          plan=plan)
    static = isinstance(engine, StaticEngine)
    sp = SamplingParams.from_rl(rl)
    rng = np.random.default_rng(args.seed)
    lo = args.prompt_len if static else max(1, args.prompt_len // 4)
    total_tok, rid = 0, 0
    t0 = time.perf_counter()
    for r in range(args.rounds):
        reqs = []
        for _ in range(args.batch):
            n = int(rng.integers(lo, args.prompt_len + 1))
            reqs.append(Request(rid=rid, params=sp, prompt=rng.integers(
                3, cfg.vocab_size, size=n).astype(np.int32)))
            rid += 1
        key, k = split(key)
        t1 = time.perf_counter()
        results = engine.generate(reqs, key=k)
        if args.device == "cuda":
            torch.cuda.synchronize()
        if not rank0:
            continue
        dt = time.perf_counter() - t1
        n_tok = sum(res.gen_count for res in results)
        total_tok += n_tok
        if not static:
            st = engine.stats()
            detail = (f"slot-util {st['slot_utilization']:.2f} "
                      f"({st['decode_steps']} decode steps, "
                      f"{st['prefill_chunks']} prefill chunks)")
        else:
            detail = f"static batch of {len(reqs)}"
        print(f"[serve] round {r}: {n_tok} tokens in {dt:.3f}s "
              f"({n_tok / dt:.1f} tok/s) | {detail} | rid "
              f"{results[0].rid}: {results[0].tokens[:8].tolist()}")
    if not rank0:
        return
    spec = ""
    if not static and engine.spec_k > 0:
        st = engine.stats()
        spec = (f" spec_k={engine.spec_k} accept_rate "
                f"{st['accept_rate']:.3f} ({st['accepted_tokens_total']}/"
                f"{st['drafted_tokens_total']} drafts, {st['spec_rounds']} "
                f"verify rounds, {st['spec_fallback_chunks']} fallback "
                f"chunks)")
    print(f"[serve] arch={cfg.name} device={args.device} "
          f"impl={engine.cfg.paged_attn_impl} "
          f"engine={'static' if static else 'continuous'} "
          f"attn={cfg.attn_impl} batch={args.batch} total "
          f"{total_tok} tokens, "
          f"{total_tok / (time.perf_counter() - t0):.1f} tok/s{spec}")


if __name__ == "__main__":
    main()
