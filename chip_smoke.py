#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA H100.

  python3 chip_smoke.py [--seed N]

Imports torch, numpy and ``repro_torch`` (from ``src/`` beside this file);
never jax, never the JAX package. Phases, each fatal on failure:

1. device: the card's name and power limit, torch/CUDA versions, and the
   kernels built from ``src/repro_torch/kernels/csrc`` with nvcc (sm_90a);
2. kernels: K3 (paged decode) and K4 (paged prefill) at the serving
   slice's shapes (bf16, Hq 16, Hkv 8, D 128, page 16, 8 slots up to 2048
   tokens with a dead slot and a NaN scratch page; prefill C = 512 and a
   ragged C = 77; one window + softcap case), each held against its plain
   PyTorch twin (float32 on the same inputs) and timed beside the twin, a
   library yardstick (SDPA over the gathered dense view, which the port
   never calls) and the card's bound;
3. engine: qwen3-1.7b at full width (28 layers, bf16, random weights from
   --seed) served through ``ContinuousEngine`` with
   ``paged_attn_impl="pallas"``: 24 requests, 4 sharing a 256-token
   prefix; every request finishes, the page pool balances, and the launch
   counters show both kernels on the path (28 per decode step and per
   prefill chunk); then a teacher-forced prefill + 8 decode steps through
   "pallas" and "ref" on copies of one pool, logits within a stated
   tolerance; last, a torch.profiler trace of 24 decode steps (device
   time by kernel, device busy share).

Prints a ``{"kernels": [...]}`` JSON line, then as the last line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device or without the rest of the repository.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.config import RLConfig, ServeConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models import decode_step, forward, init_params  # noqa: E402
from repro_torch.sampling import build_engine, init_paged_pool  # noqa: E402
from repro_torch.serving.api import Request, SamplingParams  # noqa: E402

HBM_BYTES_S = 3.35e12        # H100 SXM HBM3
BF16_FLOPS_S = 989e12        # H100 SXM dense bf16 tensor-core peak
TOL_BF16 = 2e-2              # one bf16 rounding of outputs of magnitude < 4
TOL_F32 = 1e-5               # float32 inputs: summation order only
TOL_LOGITS = 0.1             # bf16 model, 28 layers: a few bf16 ulps at |4-8|
HQ, HKV, D, PAGE, SLOTS = 16, 8, 128, 16, 8


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls,
    CUDA events, after ``warmup`` calls (L2 not flushed)."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> tuple:
    t_b, t_f = nbytes / HBM_BYTES_S, flops / BF16_FLOPS_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# --------------------------------------------------------------------------
# phase 2: the kernels at the slice's shapes


def decode_case(gen, dev, lengths, width):
    b = len(lengths)
    pool = 1 + b * width
    kp = torch.randn((pool, PAGE, HKV, D), generator=gen, device=dev)
    vp = torch.randn((pool, PAGE, HKV, D), generator=gen, device=dev)
    kp[0] = vp[0] = float("nan")             # scratch page: garbage
    table = torch.zeros((b, width), dtype=torch.int32)
    perm = torch.randperm(pool - 1, generator=torch.Generator().manual_seed(
        0)) + 1
    for s, n in enumerate(lengths):
        live = min(-(-n // PAGE), width)
        if n <= width * PAGE:                # the dead slot keeps scratch
            table[s, :live] = perm[s * width:s * width + live]
    q = torch.randn((b, HQ, D), generator=gen, device=dev)
    lens = torch.tensor(lengths, dtype=torch.int32)
    return (q.bfloat16(), kp.bfloat16(), vp.bfloat16(), table.to(dev),
            lens.to(dev))


def prefill_case(gen, dev, c, start):
    width = -(-(start + c) // PAGE)
    pool = 1 + width + 4
    kp = torch.randn((pool, PAGE, HKV, D), generator=gen, device=dev)
    vp = torch.randn((pool, PAGE, HKV, D), generator=gen, device=dev)
    kp[0] = vp[0] = float("nan")
    table = torch.arange(1, width + 1, dtype=torch.int32, device=dev)[None]
    q = torch.randn((1, c, HQ, D), generator=gen, device=dev)
    positions = (start + torch.arange(c, device=dev))[None]
    return q.bfloat16(), kp.bfloat16(), vp.bfloat16(), table, positions


def sdpa_decode(q, kp, vp, table, lengths):
    """Library yardstick setup: the dense per-slot view and its mask; the
    timed call is only the SDPA itself."""
    b, width = table.shape
    idx = table.long()
    k = kp[idx].reshape(b, width * PAGE, HKV, D).transpose(1, 2)
    v = vp[idx].reshape(b, width * PAGE, HKV, D).transpose(1, 2)
    k = k.repeat_interleave(HQ // HKV, dim=1).contiguous()
    v = v.repeat_interleave(HQ // HKV, dim=1).contiguous()
    cols = torch.arange(width * PAGE, device=q.device)
    mask = (cols[None] < lengths.long()[:, None])[:, None, None]
    return q[:, :, None], k, v, mask


def sdpa_prefill(q, kp, vp, table, positions):
    width = table.shape[1]
    idx = table.long()
    k = kp[idx].reshape(1, width * PAGE, HKV, D).transpose(1, 2)
    v = vp[idx].reshape(1, width * PAGE, HKV, D).transpose(1, 2)
    k = k.repeat_interleave(HQ // HKV, dim=1).contiguous()
    v = v.repeat_interleave(HQ // HKV, dim=1).contiguous()
    cols = torch.arange(width * PAGE, device=q.device)
    mask = (cols[None, :] <= positions[0][:, None])[None, None]
    return q.transpose(1, 2).contiguous(), k, v, mask


def library_ms(args) -> float:
    q, k, v, mask = args
    return time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask))


def max_err(got, want, rows=slice(None)):
    return float((got[rows].float() - want[rows].float()).abs().max())


def kernel_phase(dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    width = 2048 // PAGE
    lengths = [2048, 1537, 1024, 700, 333, 64, 1, width * PAGE + 1]
    live = slice(0, SLOTS - 1)               # the dead slot's row is junk
    q, kp, vp, table, lens = decode_case(gen, dev, lengths, width)
    f32 = [t.float() for t in (q, kp, vp)]
    out = {}

    # K3 ---------------------------------------------------------------
    got = pa.paged_attention(q, kp, vp, table, lens)
    want = pa.paged_decode_ref(*f32, table, lens)
    got32 = pa.paged_attention(*f32, table, lens)
    torch.cuda.synchronize()
    err, err32 = max_err(got, want, live), max_err(got32, want, live)
    if not torch.isfinite(got[live].float()).all():
        raise AssertionError("K3: non-finite output on a live slot")
    gw = pa.paged_attention(q, kp, vp, table, lens, window=256, softcap=50.0)
    ww = pa.paged_decode_ref(*f32, table, lens, window=256, softcap=50.0)
    err_w = max_err(gw, ww, live)
    log(f"[kernels] K3 paged_decode: max|err| bf16 {err:.3e} (tol "
        f"{TOL_BF16}), f32 {err32:.3e} (tol {TOL_F32}), window+softcap "
        f"{err_w:.3e}")
    if err > TOL_BF16 or err_w > TOL_BF16 or err32 > TOL_F32:
        raise AssertionError("K3 disagrees with its twin")
    # live slots only: the dead slot's block walks no page
    keys = [n for n in lengths if n <= width * PAGE]
    kv_bytes = sum(-(-k // PAGE) * PAGE for k in keys) * HKV * D * 2 * 2
    nbytes = kv_bytes + 2 * q.numel() * 2 + table.numel() * 4 + 4 * SLOTS
    flops = sum(4 * HQ * D * k for k in keys)
    b_ms, b_by = bound(nbytes, flops)
    out["paged_decode"] = dict(
        name="paged_decode_kernel", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:85 (_kernel; "
                 "pallas_call at :177)",
        max_abs_err=err, max_abs_err_f32=err32, tol=TOL_BF16,
        ms=time_ms(lambda: pa.paged_attention(q, kp, vp, table, lens)),
        plain_ms=time_ms(lambda: pa.paged_decode_ref(q, kp, vp, table,
                                                     lens), iters=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=library_ms(sdpa_decode(q, kp, vp, table, lens)),
        shape=f"B={SLOTS} Hq={HQ} Hkv={HKV} D={D} page={PAGE} "
              f"lengths={lengths} bf16")

    # K4 ---------------------------------------------------------------
    rows = {}
    for c, start in ((512, 1024), (77, 300)):
        q, kp, vp, table, pos = prefill_case(gen, dev, c, start)
        f32 = [t.float() for t in (q, kp, vp)]
        got = ops.paged_prefill(q, kp, vp, table, pos, impl="pallas")
        want = ops.paged_prefill(*f32, table, pos, impl="ref")
        got32 = ops.paged_prefill(*f32, table, pos, impl="pallas")
        gw = ops.paged_prefill(q, kp, vp, table, pos, kind="local",
                               window=256, softcap=50.0, impl="pallas")
        ww = ops.paged_prefill(*f32, table, pos, kind="local", window=256,
                               softcap=50.0, impl="ref")
        torch.cuda.synchronize()
        errs = (max_err(got, want), max_err(got32, want), max_err(gw, ww))
        log(f"[kernels] K4 paged_prefill C={c} start={start}: max|err| bf16 "
            f"{errs[0]:.3e}, f32 {errs[1]:.3e}, window+softcap "
            f"{errs[2]:.3e}")
        if errs[0] > TOL_BF16 or errs[2] > TOL_BF16 or errs[1] > TOL_F32:
            raise AssertionError(f"K4 (C={c}) disagrees with its twin")
        rows[c] = (q, kp, vp, table, pos, errs)
    q, kp, vp, table, pos, errs = rows[512]
    c, start = 512, 1024
    kv_bytes = -(-(start + c) // PAGE) * PAGE * HKV * D * 2 * 2
    nbytes = kv_bytes + 2 * q.numel() * 2 + table.numel() * 4
    flops = sum(4 * HQ * D * (start + i + 1) for i in range(c))
    b_ms, b_by = bound(nbytes, flops)
    out["paged_prefill"] = dict(
        name="paged_prefill_kernel", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:245 "
                 "(_prefill_kernel; pallas_call at :376)",
        max_abs_err=max(errs[0], rows[77][5][0]),
        max_abs_err_f32=max(errs[1], rows[77][5][1]), tol=TOL_BF16,
        ms=time_ms(lambda: ops.paged_prefill(q, kp, vp, table, pos,
                                             impl="pallas")),
        plain_ms=time_ms(lambda: ops.paged_prefill(q, kp, vp, table, pos,
                                                   impl="ref"), iters=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=library_ms(sdpa_prefill(q, kp, vp, table, pos)),
        shape=f"B=1 C={c} start={start} Hq={HQ} Hkv={HKV} D={D} "
              f"page={PAGE} bf16 (+ C=77 start=300 checked)")
    return out


# --------------------------------------------------------------------------
# phase 3: the engine at full width


def engine_phase(dev, seed, card):
    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              paged_attn_impl="pallas")
    t0 = time.perf_counter()
    params = init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    log(f"[engine] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size} (padded "
        f"{cfg.padded_vocab}), {cfg.param_count() / 1e9:.3f}B params bf16, "
        f"init {time.perf_counter() - t0:.1f}s")
    serve = ServeConfig(num_slots=SLOTS, page_size=PAGE, prefill_chunk=512,
                        sync_every=8, max_total_tokens=2048,
                        paged_attn_impl="pallas", seed=seed)
    rl = RLConfig()                          # temperature 0.6, top-k 20, top-p 0.95
    eng = build_engine(cfg, params, serve, rl=rl, vocab_limit=cfg.vocab_size)
    sp = SamplingParams.from_rl(rl, max_new=64)
    rng = np.random.default_rng(seed)
    prefix = rng.integers(3, cfg.vocab_size, 256)
    lens = rng.integers(64, 1537, 24)
    prompts = []
    for i, n in enumerate(lens):
        if i in (0, 9, 19):                  # share a 256-token prefix
            n = max(int(n), 320)
            tail = rng.integers(3, cfg.vocab_size, n - 256)
            prompts.append(np.concatenate([prefix, tail]))
        elif i == 14:
            # the prefix alone: the cache serves 255 tokens (the last
            # prompt token is always prefilled), so admission copies the
            # partial 16th page on write
            prompts.append(prefix.copy())
        else:
            prompts.append(rng.integers(3, cfg.vocab_size, int(n)))

    # warm-up: cuBLAS handles, allocator, first launches
    eng.generate([Request(rid=1000 + i, prompt=prompts[i][:64], params=sp)
                  for i in range(2)])
    torch.cuda.synchronize()
    st0 = eng.stats()

    pa.reset_launch_counts()
    t_start = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p.astype(np.int32), params=sp,
                           arrival_s=t_start))
    decode_round_ms = []
    results = {}
    while len(results) < len(prompts):
        before = eng.stats()
        t1 = time.perf_counter()
        for ev in eng.step():
            if ev.finished:
                results[ev.rid] = eng.pop_result(ev.rid)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        after = eng.stats()
        if after["prefill_chunks"] == before["prefill_chunks"] and \
                after["decode_steps"] > before["decode_steps"]:
            decode_round_ms.append(dt * 1e3 / eng.sync_every)
        if not eng.has_work() and len(results) < len(prompts):
            raise AssertionError("engine drained with requests unfinished")
    wall = time.perf_counter() - t_start
    launches = dict(pa.LAUNCHES)
    st = eng.stats()
    d_steps = st["decode_steps"] - st0["decode_steps"]
    p_chunks = st["prefill_chunks"] - st0["prefill_chunks"]
    if launches["paged_decode"] != cfg.num_layers * d_steps or \
            launches["paged_prefill"] != cfg.num_layers * p_chunks:
        raise AssertionError(f"launch counts {launches} != {cfg.num_layers} "
                             f"x ({d_steps} decode steps, {p_chunks} "
                             "prefill chunks)")
    res = [results[i] for i in range(len(prompts))]
    for r in res:
        if r.finish_reason not in ("eos", "length"):
            raise AssertionError(f"request {r.rid}: {r.finish_reason}")
        if r.gen_count < 1 or not np.isfinite(r.logps).all() \
                or (r.logps > 1e-6).any():
            raise AssertionError(f"request {r.rid}: bad logps")
        if (r.tokens < 0).any() or (r.tokens >= cfg.vocab_size).any():
            raise AssertionError(f"request {r.rid}: token out of vocab")
    hits = sum(r.prefix_hit_tokens for r in res)
    cow = st["cow_copies"] - st0["cow_copies"]
    if hits == 0 or cow == 0:
        raise AssertionError(f"prefix reuse not exercised: {hits} hit "
                             f"tokens, {cow} copy-on-write copies")
    eng.prefix_cache.clear()
    if eng.free_pages != eng.num_pages - 1 or eng.sched.allocator.in_use:
        raise AssertionError("page pool does not balance after drain")
    n_tok = sum(r.gen_count for r in res)
    ttft = statistics.median(r.ttft_s for r in res) * 1e3
    dec_ms = statistics.median(decode_round_ms) if decode_round_ms \
        else float("nan")
    log(f"[engine] 24 requests, {n_tok} tokens in {wall:.2f}s: "
        f"{n_tok / wall:.1f} tokens/s, TTFT median {ttft:.1f} ms "
        f"(queueing included), decode {dec_ms:.2f} ms/step (median of "
        f"{len(decode_round_ms)} pure-decode rounds) | {card}")
    log(f"[engine] {d_steps} decode steps, {p_chunks} prefill chunks, "
        f"launches {launches} (= {cfg.num_layers} per step/chunk), prefix "
        f"hit tokens {hits}, CoW copies {cow}, slot util "
        f"{st['slot_utilization']:.3f}")
    teacher_forced(cfg, params, dev, seed)
    profile_decode(eng, prompts, sp)
    return launches


def profile_decode(eng, prompts, sp):
    """Trace 3 pure-decode scheduler rounds (8 slots, 24 decode steps)
    with torch.profiler; print device time by kernel and the device's busy
    share of the window's wall time (where the decode step's time goes)."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(eng.num_slots):
        eng.submit(Request(rid=2000 + i, prompt=prompts[i][:512].astype(
            np.int32), params=sp))
    while any(r is None or r.state != "decode" for r in eng.sched.slots):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device-side entries only (kernels, memcpy/memset): the CPU op that
    # launched a kernel reports the same time again
    rows = sorted((e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")),
                  key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    log(f"[profile] 24 decode steps: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% of wall; sum of "
        f"device-side time, profiler on), {len(rows)} kernel names")
    # host-side calls that wait for the device (the last one is the
    # window's own torch.cuda.synchronize)
    waits = {e.key: e.count for e in prof.key_averages()
             if any(w in e.key for w in ("Synchronize", "nonzero",
                                          "_local_scalar_dense", "Memcpy"))}
    log(f"[profile] host waits in the window: {waits}")
    for e in rows[:12]:
        log(f"[profile] {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.key[:90]}")
    while eng.has_work():
        eng.step()


def teacher_forced(cfg, params, dev, seed):
    """One 512-token prefill chunk plus 8 forced decode steps through the
    kernels and through the twins, on copies of one pool."""
    rng = np.random.default_rng(seed + 1)
    c, steps = 512, 8
    width = -(-(c + steps) // PAGE)
    pool = init_paged_pool(cfg, width + 2, PAGE, device=dev)
    for layer in pool.values():
        for leaf in layer["self"].values():
            leaf[:, 0] = float("nan")
    pools = {"pallas": pool,
             "ref": {k: {"self": {n: t.clone() for n, t in v["self"].items()}}
                     for k, v in pool.items()}}
    table = torch.arange(1, width + 1, dtype=torch.int32, device=dev)[None]
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, c + steps)
                            ).to(dev)
    logits = {}
    for impl in ("pallas", "ref"):
        icfg = dataclasses.replace(cfg, paged_attn_impl=impl)
        with torch.no_grad():
            lg, _, _ = forward(icfg, params, toks[None, :c],
                               positions=torch.arange(c, device=dev)[None],
                               cache=pools[impl], page_table=table)
            rows = [lg[0, -1]]
            for i in range(steps):
                lg1, _ = decode_step(icfg, params, pools[impl],
                                     toks[c + i:c + i + 1],
                                     torch.tensor([c + i], device=dev),
                                     page_table=table)
                rows.append(lg1[0])
        logits[impl] = (lg[0], torch.stack(rows))
    torch.cuda.synchronize()
    err_p = float((logits["pallas"][0] - logits["ref"][0]).abs().max())
    err_d = float((logits["pallas"][1] - logits["ref"][1]).abs().max())
    scale = float(logits["ref"][0].abs().max())
    agree = float((logits["pallas"][1].argmax(-1)
                   == logits["ref"][1].argmax(-1)).float().mean())
    log(f"[teacher-forced] max|logit diff| prefill {err_p:.3e}, decode "
        f"{err_d:.3e} (tol {TOL_LOGITS}, max|logit| {scale:.2f}); greedy "
        f"agreement {agree:.3f} (information only)")
    for part in logits.values():
        if not all(torch.isfinite(t).all() for t in part):
            raise AssertionError("teacher-forced logits not finite")
    if max(err_p, err_d) > TOL_LOGITS:
        raise AssertionError("pallas and ref logits disagree")


# --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="PyTorch port smoke on one GPU")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {card}")
    log(f"[device] python {sys.version.split()[0]}, torch {torch.__version__},"
        f" CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    built = build.build()
    log(f"[build] {build.SOURCE.name}: {built.seconds:.1f}s nvcc (sm_90a)")
    for line in built.log.splitlines():
        if "Used" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    kernels = kernel_phase(dev, args.seed)
    launches = engine_phase(dev, args.seed, card)
    for name, row in kernels.items():
        row["launches"] = launches[name]
        row["kernel_ms"], row["twin_ms"] = row["ms"], row["plain_ms"]
        row["card"] = card
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
