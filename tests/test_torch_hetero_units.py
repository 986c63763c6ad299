"""The HeteroRL loop's inputs and state in the PyTorch port against the JAX
package: the task and prompt pipeline, the latency models, the event
simulation, ``obs``, the checkpoint codec and ``PolicyStore``, and the
chunked weight transport.

These are the pieces whose outputs are data, so they are held exactly:
the same seeds give the same problems, prompt arrays, rewards and delays
(floats equal bit for bit), both ``obs`` packages export the same text
and JSON, and a checkpoint blob, a chunk hash or a manifest written by
either package is byte-identical to, and loads in, the other.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.checkpoint import store as jstore
from repro.config import HeteroConfig as JHeteroConfig
from repro.configs import smoke as jsmoke
from repro.data import pipeline as jpipeline
from repro.data import tasks as jtasks
from repro.hetero import events as jevents
from repro.hetero import latency as jlatency
from repro.models import init_params as jinit_params
from repro.parallel import local_plan
from repro import transport as jtransport
from repro_torch import obs as tobs
from repro_torch.checkpoint import store as tstore
from repro_torch.config import HeteroConfig
from repro_torch.configs import smoke as tsmoke
from repro_torch.data import pipeline as tpipeline
from repro_torch.data import tasks as ttasks
from repro_torch.hetero import events as tevents
from repro_torch.hetero import latency as tlatency
from repro_torch.models import params_from_numpy
from repro_torch.optim import tree_leaves
from repro_torch.parallel import local_plan as tlocal_plan
from repro_torch import transport as ttransport


# --------------------------------------------------------------------------
# data: task, tokenizer, pipeline, rewards


@pytest.mark.parametrize("ops,width,top", [("+-", 8, 99), ("+-*", 832, 99),
                                           ("+", 5, 9)])
def test_task_and_pipeline_match_jax(ops, width, top):
    jt = jtasks.ArithmeticTask(max_operand=top, ops=ops, prompt_width=width,
                               seed=7)
    tt = ttasks.ArithmeticTask(max_operand=top, ops=ops, prompt_width=width,
                               seed=7)
    jp = jtasks.encode_prompts(jtasks.Tokenizer(), jt.sample_batch(5))
    tp = ttasks.encode_prompts(ttasks.Tokenizer(), tt.sample_batch(5))
    assert tp.dtype == jp.dtype and tp.shape == (5, width)
    np.testing.assert_array_equal(tp, jp)
    jpipe = jpipeline.PromptPipeline(jt, jtasks.Tokenizer(), 3, 4)
    tpipe = tpipeline.PromptPipeline(tt, ttasks.Tokenizer(), 3, 4)
    for _ in range(3):
        jr, tr = jpipe.next_batch(), tpipe.next_batch()
        np.testing.assert_array_equal(tr.prompts, jr.prompts)
        assert tr.group_size == jr.group_size == 4
        assert [dataclasses.astuple(p) for p in tr.problems] == \
            [dataclasses.astuple(p) for p in jr.problems]


def test_tokenizer_and_rewards_match_jax():
    jtok, ttok = jtasks.Tokenizer(), ttasks.Tokenizer()
    assert ttok.vocab_size == jtok.vocab_size
    assert (ttasks.PAD, ttasks.BOS, ttasks.EOS) == (jtasks.PAD, jtasks.BOS,
                                                    jtasks.EOS)
    s = " 12+3=15"
    assert ttok.encode(s, bos=True, eos=True) == \
        jtok.encode(s, bos=True, eos=True)
    task = jtasks.ArithmeticTask(max_operand=20, ops="+-", seed=3)
    ttask = ttasks.ArithmeticTask(max_operand=20, ops="+-", seed=3)
    probs, tprobs = task.sample_batch(4), ttask.sample_batch(4)
    rng = np.random.default_rng(0)
    comps = rng.integers(0, jtok.vocab_size, (16, 6)).astype(np.int32)
    for i, p in enumerate(probs):          # one right answer per group
        ans = jtok.encode(p.answer) + [jtasks.EOS]
        comps[4 * i, :len(ans)] = ans
    want = jpipeline.score_rollouts(task, jtok, probs, comps, 4)
    got = tpipeline.score_rollouts(ttask, ttok, tprobs, comps, 4)
    assert got.dtype == want.dtype and want.sum() >= 4
    np.testing.assert_array_equal(got, want)
    assert [ttok.decode(r) for r in comps] == [jtok.decode(r) for r in comps]
    # prompts wider than the rendered width cannot share a batch
    wide = ttasks.ArithmeticTask(max_operand=99, ops="+", prompt_width=3)
    with pytest.raises(ValueError, match="one rendered width"):
        ttasks.encode_prompts(ttok, wide.sample_batch(8))


# --------------------------------------------------------------------------
# latency and the event simulation


@pytest.mark.parametrize("dist", ["lognormal", "weibull", "exponential",
                                  "constant"])
@pytest.mark.parametrize("bandwidth", [float("inf"), 100.0])
def test_delays_match_jax_bit_for_bit(dist, bandwidth):
    kw = dict(delay_distribution=dist, delay_median_s=300.0,
              bandwidth_mbps=bandwidth)
    jh, th = JHeteroConfig(**kw), HeteroConfig(**kw)
    jr, tr = np.random.default_rng(11), np.random.default_rng(11)
    for i in range(200):
        assert tlatency.sample_delay(tr, th) == \
            jlatency.sample_delay(jr, jh)
        payload = (i % 3) * 10 ** 7
        assert tlatency.sync_delay_s(tr, th, payload) == \
            jlatency.sync_delay_s(jr, jh, payload)
    assert tlatency.DISTRIBUTIONS == jlatency.DISTRIBUTIONS


def test_unknown_delay_distribution_raises():
    with pytest.raises(ValueError, match="unknown delay distribution"):
        tlatency.sample_delay(np.random.default_rng(0),
                              HeteroConfig(delay_distribution="cauchy"))


def _scripted_sim(mod):
    """A schedule with ties, reentrant scheduling and a stop predicate."""
    sim = mod.EventSim()
    net = mod.Transport(sim)
    fired = []

    def ev(name, then=()):
        def fn():
            fired.append((name, sim.now))
            for delay, nxt in then:
                sim.schedule(delay, ev(nxt))
        return fn

    sim.schedule(5.0, ev("a", [(0.0, "a0"), (2.5, "a1")]))
    sim.schedule(5.0, ev("b"))
    sim.schedule(1.0, ev("c", [(4.0, "c4"), (0.0, "c0")]))
    sim.schedule(0.0, ev("d"))
    net.send(7.5, ev("msg"), nbytes=100)
    net.send(3.0, ev("msg2"), nbytes=28)
    sim.run_until(t_end=7.0)
    sim.schedule(30.0, ev("late"))
    sim.run_until(stop=lambda: len(fired) >= 11)
    return fired, sim.now, net.messages_sent, net.bytes_sent


def test_event_sim_fires_in_the_reference_order():
    got, want = _scripted_sim(tevents), _scripted_sim(jevents)
    assert got == want
    assert [n for n, _ in got[0]][:4] == ["d", "c", "c0", "msg2"]


# --------------------------------------------------------------------------
# obs: the same scenario through both packages, outputs compared


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _metrics_scenario(obs):
    reg = obs.MetricsRegistry(enabled=True)
    c = reg.counter("batches_total", "rollout batches", sampler=0)
    c.inc()
    c.inc(2.5)
    reg.counter("batches_total", sampler=1).inc(4)
    g = reg.gauge("policy version", "version held", sampler=0)
    g.add(3)
    g.set(7)
    reg.gauge("nan_gauge")
    h = reg.histogram("step_seconds", "step time", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 2.0, 50.0, float("nan"), 1.0):
        h.observe(v)
    reg.set_many("learner", {"loss": 0.25, "kl": float("inf"),
                             "bad": "text", "step": 3})
    errors = []
    for bad in (lambda: c.inc(-1), lambda: reg.gauge("batches_total")):
        try:
            bad()
        except ValueError as e:
            errors.append(str(e))
    for i in range(obs.registry.MAX_CHILDREN_PER_FAMILY + 1):
        try:
            reg.counter("wide_total", rid=i)
        except ValueError as e:
            errors.append(str(e))
    out = [reg.snapshot(), reg.prometheus_text()]
    reg.enabled = False
    c.inc(100)
    reg.enabled = True
    reg.clear()
    c.inc()
    out += [reg.snapshot(), reg.prometheus_text(), errors]
    res = obs.Reservoir(capacity=8, seed=3)
    for v in range(100):
        res.add(v * 0.5)
    return out + [res.values, len(res), res.n]


def _tracer_scenario(obs, tmp_path):
    tr = obs.Tracer(enabled=True, clock=FakeClock(), max_events=64)
    with tr.track("learner"):
        with tr.span("step", step=1):
            with tr.span("publish", bytes=10):
                tr.instant("chunk", n=2)
        try:
            with tr.span("sync", sampler=3):
                raise KeyError("pruned")
        except KeyError:
            pass
    tr.complete("gen_window", 1.0, 3.5, track="sampler-0", version=2)
    fid = tr.next_flow_id()
    tr.async_begin("chunk_transfer", fid, cat="transport", ts=2.0,
                   track="sampler-1", bytes=4)
    tr.async_end("chunk_transfer", fid, cat="transport", ts=2.5,
                 track="sampler-1")
    sim = type("Sim", (), {"now": 42.0})()
    tr.use_sim(sim)
    with tr.span("sim_span", track="sampler-0"):
        sim.now = 50.0
    off = obs.Tracer(enabled=False)
    assert off.span("x") is off.span("y")
    path = tmp_path / f"{obs.__name__}.json"
    n = obs.write_chrome_trace(tr, str(path), "hetero")
    return [tr.events(), obs.chrome_trace(tr, "hetero"), n,
            obs.validate_chrome_trace(str(path)), len(tr)]


@pytest.mark.parametrize("scenario", ["metrics", "tracer"])
def test_obs_outputs_match_jax(scenario, tmp_path):
    if scenario == "metrics":
        got, want = _metrics_scenario(tobs), _metrics_scenario(jobs)
    else:
        got = _tracer_scenario(tobs, tmp_path)
        want = _tracer_scenario(jobs, tmp_path)
    assert json.dumps(got, default=str) == json.dumps(want, default=str)


# --------------------------------------------------------------------------
# checkpoint: the npz blob both ways, PolicyStore bookkeeping


def _tcfg(dtype):
    """The port's twin of ``_model_params``'s JAX config."""
    return dataclasses.replace(tsmoke("qwen3-1.7b"), dtype=dtype)


def _model_params(dtype, extra=False):
    """The JAX package's smoke qwen3 params and the same in torch; with
    ``extra``, an int32 leaf and a 0-dim leaf beside them."""
    jcfg = dataclasses.replace(jsmoke("qwen3-1.7b"), dtype=dtype)
    jp = jinit_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    if extra:
        jp = dict(jp, extra={"count": jnp.arange(5, dtype=jnp.int32),
                             "scale": jnp.float32(1.5)})
        tp = dict(tp, extra={"count": torch.arange(5, dtype=torch.int32),
                             "scale": torch.tensor(1.5)})
    return jcfg, jp, tp


def _assert_same(tp, jp):
    jl = jax.tree_util.tree_leaves(jp)
    tl = tree_leaves(tp)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert tstore.dtype_name(t.dtype) == str(j.dtype)
        assert tuple(t.shape) == j.shape
        assert tstore.encode_array(t) == np.asarray(j).tobytes()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_checkpoint_blobs_load_both_ways(dtype):
    _, jp, tp = _model_params(dtype, extra=True)
    assert [k for k, _ in tstore.flatten_with_paths(tp)] == \
        [k for k, _ in jstore.flatten_with_paths(jp)]
    _assert_same(tp, jp)
    _assert_same(tp, jstore.load_pytree(tstore.save_pytree(tp), jp))
    _assert_same(tstore.load_pytree(jstore.save_pytree(jp), tp), jp)
    back = tstore.load_pytree(tstore.save_pytree(tp), tp)
    for a, b in zip(tree_leaves(back), tree_leaves(tp)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _store_script(mod):
    store = mod.PolicyStore(keep=2, track=4)
    out = []
    for v in range(6):
        store.publish(v, bytes([v]) * (v + 1))
    store.publish(5, b"xy")                           # replaced: delta only
    out.append((store.latest_version(), store.fetch(), store.fetch(4),
                store.bytes_published))
    out.append((store.fetch(3), store.fetch(0), store.stale_fetches))
    for bad in (10, -7):
        try:
            store.fetch(bad)
        except KeyError as e:
            out.append(str(e))
    chunks = mod.PolicyStore(keep=2)
    for v in range(5):
        data = bytes([v]) * 8
        h = jtransport.content_hash(data)
        out.append(chunks.put_chunk(h, data))
        out.append(chunks.put_chunk(h, data))
        chunks.publish_manifest(v, b"m%d" % v, [h])
    try:
        chunks.publish_manifest(9, b"{}", ["deadbeef"])
    except KeyError as e:
        out.append(str(e))
    out.append((chunks.num_chunks, chunks.chunks_gced,
                chunks.chunk_index_bytes(), chunks.has_chunk(h),
                chunks.bytes_published))
    try:
        mod.PolicyStore().fetch()
    except KeyError as e:
        out.append(str(e))
    return out


def test_policy_store_versions_degrade_and_gc_match_jax():
    assert _store_script(tstore) == _store_script(jstore)


# --------------------------------------------------------------------------
# transport: hashes, manifests, cross-package sync, delta sync, resume


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_chunk_hashes_and_manifest_match_jax(dtype):
    jcfg, jp, tp = _model_params(dtype)
    js, ts = jstore.PolicyStore(), tstore.PolicyStore()
    jst = jtransport.publish_params(js, 3, local_plan("train"), jcfg, jp)
    tst = ttransport.publish_params(ts, 3, tlocal_plan(), _tcfg(dtype), tp)
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
    assert ts.fetch(3)[1] == js.fetch(3)[1]           # manifest JSON bytes
    man = jtransport.Manifest.from_json(ts.fetch(3)[1])
    tman = ttransport.Manifest.from_json(js.fetch(3)[1])
    assert man.to_json() == tman.to_json() == ts.fetch(3)[1]
    assert tman.hashes() == man.hashes()
    assert {h: ts.get_chunk(h) for h in man.hashes()} == \
        {h: js.get_chunk(h) for h in man.hashes()}
    # a port-published version through the reference subscriber, and the
    # reverse, assemble the same bytes
    v, jtree, _ = jtransport.ChunkSubscriber(ts).sync(jp)
    assert v == 3
    _assert_same(tp, jtree)
    v, ttree, stats = ttransport.ChunkSubscriber(js).sync(tp)
    assert v == 3 and stats.chunk_bytes == jst.bytes_new
    _assert_same(ttree, jp)
    for a, b in zip(tree_leaves(ttree), tree_leaves(tp)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_delta_sync_moves_only_changed_chunks():
    _, _, tp = _model_params("bfloat16")
    tcfg = _tcfg("bfloat16")
    store = tstore.PolicyStore()
    st0 = ttransport.publish_params(store, 0, tlocal_plan(), tcfg, tp)
    sub = ttransport.ChunkSubscriber(store)
    _, _, s0 = sub.sync(tp)
    assert s0.chunk_bytes == st0.bytes_new and s0.chunks_fetched > 0
    st1 = ttransport.publish_params(store, 1, tlocal_plan(), tcfg, tp)
    assert st1.bytes_new == 0 and st1.chunks_new == 0
    v, tree1, s1 = sub.sync(tp)
    assert v == 1 and s1.chunks_fetched == 0 and s1.dedup_ratio == 1.0
    assert s1.bytes_on_wire == s1.manifest_bytes
    changed = {**tp, "final_norm": tp["final_norm"] + 1.0}
    st2 = ttransport.publish_params(store, 2, tlocal_plan(), tcfg,
                                   changed)
    assert st2.chunks_new == 1
    assert st2.bytes_new == changed["final_norm"].numel() * 2
    v, tree2, s2 = sub.sync(tp)
    assert v == 2 and s2.chunks_fetched == 1
    assert s2.chunk_bytes == st2.bytes_new
    for a, b in zip(tree_leaves(tree2), tree_leaves(changed)):
        assert torch.equal(a, b)


def test_resume_after_drop_matches_jax():
    jcfg, jp, tp = _model_params("float32")
    out = {}
    for name, mod, params, kw in (
            ("port", ttransport, tp, {}),
            ("jax", jtransport, jp, {"plan": local_plan("train"),
                                     "cfg": jcfg})):
        store = (tstore if name == "port" else jstore).PolicyStore()
        if name == "port":
            st0 = mod.publish_params(store, 0, tlocal_plan(),
                                     _tcfg("float32"), params)
        else:
            st0 = mod.publish_params(store, 0, kw["plan"], jcfg, params)
        link = mod.SimulatedLink(bandwidth_mbps=100.0,
                                 drop_after_bytes=st0.bytes_new // 3)
        sub = mod.ChunkSubscriber(store, link)
        with pytest.raises(mod.SyncInterrupted, match="resumes"):
            sub.sync(params)
        partial = link.bytes_on_wire
        v, tree, ss = sub.sync(params)
        out[name] = (partial, link.bytes_on_wire, link.drops, link.seconds,
                     dataclasses.asdict(ss), sub.bytes_fetched)
        assert link.bytes_on_wire == st0.bytes_new + 2 * ss.manifest_bytes
    assert out["port"] == out["jax"]
    assert out["port"][4]["bytes_resumed"] > 0
