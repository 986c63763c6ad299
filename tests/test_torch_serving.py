"""The port's serving front door (``repro_torch.serving``: admission
control, SLO telemetry, the asyncio HTTP/websocket ``FrontDoor``,
``launch/serve.py --listen``) against the JAX package's ``repro.serving``,
on ``tests/test_serving.py``'s ``TINY`` with the same params (carried
across with ``params_from_numpy``) and ``PRNGKey(3)``.

Held exactly: admission decisions and their details, percentiles, the
telemetry snapshot, the tokens of every request over HTTP, NDJSON and the
websocket (the threefry draws are the reference's). Logps within 1e-5
(float32, the two frameworks' sums in another order). Both doors get the
same requests in the same order, so they assign the same rids.

Torch runs one thread in this module, as in ``test_torch_hetero_loop.py``:
the door steps the engine on an executor thread beside the event loop.
"""
import asyncio
import json
import math
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.config import ATTN as JATTN
from repro.config import MLP as JMLP
from repro.config import ModelConfig as JModelConfig
from repro.config import RLConfig as JRLConfig
from repro.config import ServeConfig as JServeConfig
from repro.models import init_params as jinit_params
from repro.sampling import build_engine as jbuild_engine
from repro.serving import AdmissionController as JAdmissionController
from repro.serving.api import GenerationResult as JGenerationResult
from repro.serving.api import Request as JRequest
from repro.serving.api import SamplingParams as JSamplingParams
from repro.serving.server import FrontDoor as JFrontDoor
from repro.serving.telemetry import ServeTelemetry as JServeTelemetry
from repro.serving.telemetry import percentile as jpercentile
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro_torch import obs
from repro_torch.config import ATTN, MLP, ModelConfig, RLConfig, ServeConfig
from repro_torch.models import params_from_numpy
from repro_torch.obs import MetricsRegistry
from repro_torch.sampling import build_engine, pages_for
from repro_torch.sampling.prng import as_key
from repro_torch.serving import (EXPIRED, INFEASIBLE, OK, OVERLOADED,
                                 QUEUE_FULL, AdmissionController, Engine,
                                 ServeTelemetry)
from repro_torch.serving.api import GenerationResult, Request, SamplingParams
from repro_torch.serving.server import FrontDoor
from repro_torch.serving.telemetry import percentile

ROOT = Path(__file__).resolve().parents[1]
SHAPE = dict(name="tiny-serve", family="dense", num_layers=2, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=32,
             dtype="float32", attn_impl="naive", remat=False,
             rope_theta=1e4)
TOL_LP = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    jcfg = JModelConfig(block_pattern=(JATTN,), ffn_pattern=(JMLP,),
                        **SHAPE)
    tcfg = ModelConfig(block_pattern=(ATTN,), ffn_pattern=(MLP,), **SHAPE)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _serve(**kw):
    """``tests/test_serving.py::_serve``."""
    kw.setdefault("num_slots", 2)
    kw.setdefault("page_size", 4)
    kw.setdefault("sync_every", 4)
    kw.setdefault("max_total_tokens", 20)
    return kw


def _prompt(rng, n):
    return rng.integers(4, 30, size=n).astype(np.int32)


def _engines(tiny, serve, rl_kw):
    jcfg, jp, tcfg, tp = tiny
    key = jax.random.PRNGKey(3)
    jeng = jbuild_engine(jcfg, jp, JServeConfig(**serve), rl=JRLConfig(
        **rl_kw), vocab_limit=20, key=key)
    teng = build_engine(tcfg, tp, ServeConfig(**serve), rl=RLConfig(
        **rl_kw), vocab_limit=20, key=as_key(np.asarray(key)))
    return jeng, teng


# --------------------------------------------------------------------------
# admission control


def test_admission_reject_taxonomy_matches_jax(tiny):
    """``tests/test_serving.py::test_reject_taxonomy`` on both packages:
    the same decisions, reasons and details at every step."""
    rl_kw = dict(temperature=1.0, top_k=0, top_p=1.0, max_new_tokens=8,
                 engine="continuous")
    serve = _serve(max_total_tokens=16, max_queue=3, queue_overcommit=1.0,
                   prefix_cache=False)
    jeng, teng = _engines(tiny, serve, rl_kw)
    jadm = JAdmissionController(JServeConfig(**serve), jeng)
    tadm = AdmissionController(ServeConfig(**serve), teng)
    jsp, tsp = JSamplingParams.from_rl(JRLConfig(**rl_kw)), \
        SamplingParams.from_rl(RLConfig(**rl_kw))
    ok = _prompt(np.random.default_rng(0), 8)
    big = _prompt(np.random.default_rng(1), 12)

    def check(rid, prompt, now, want, **kw):
        a = jadm.check(JRequest(rid=rid, prompt=prompt, params=jsp, **kw),
                       now_s=now)
        b = tadm.check(Request(rid=rid, prompt=prompt, params=tsp, **kw),
                       now_s=now)
        assert (b.admitted, b.reason, b.detail) == \
            (a.admitted, a.reason, a.detail)
        assert b.reason == want and bool(b) == (want == OK)

    check(0, ok, 0.0, OK)
    check(1, big, 0.0, INFEASIBLE)                  # 12 + 8 > 16 tokens
    check(2, ok, 2.0, EXPIRED, deadline_s=1.0)
    for r in (3, 4):
        jeng.submit(JRequest(rid=r, prompt=ok, params=jsp))
        teng.submit(Request(rid=r, prompt=ok, params=tsp))
    check(5, ok, 0.0, OVERLOADED)                   # 8 pages promised
    jeng.submit(JRequest(rid=6, prompt=ok, params=jsp))
    teng.submit(Request(rid=6, prompt=ok, params=tsp))
    check(7, ok, 0.0, QUEUE_FULL)
    assert tadm.rejected == jadm.rejected == {
        INFEASIBLE: 1, EXPIRED: 1, QUEUE_FULL: 1, OVERLOADED: 1}
    assert tadm.rejected_total == 4
    while teng.has_work():                          # drain the three
        teng.step()
    assert teng.sched.queue_depth == 0 and teng.sched.stats["completed"] == 3


def test_shared_prefix_discount_matches_jax(tiny):
    """A request whose prefix is cached is charged only the pages it would
    newly allocate: with the queue's promised pages just under the budget
    for a cold request, the sharer is admitted and the cold request shed,
    on both packages alike."""
    rl_kw = dict(temperature=1.0, top_k=0, top_p=1.0, max_new_tokens=4,
                 engine="continuous")
    serve = _serve(queue_overcommit=1.0)
    jeng, teng = _engines(tiny, serve, rl_kw)
    jsp, tsp = JSamplingParams.from_rl(JRLConfig(**rl_kw)), \
        SamplingParams.from_rl(RLConfig(**rl_kw))
    prompt = _prompt(np.random.default_rng(9), 16)
    jeng.generate([JRequest(rid=0, prompt=prompt, params=jsp)])
    teng.generate([Request(rid=0, prompt=prompt, params=tsp)])
    jm, jshared, _ = jeng.prefix_cache.peek(prompt)
    tm, tshared, _ = teng.prefix_cache.peek(prompt)
    assert (tm, len(tshared)) == (jm, len(jshared)) and len(tshared) > 0
    need = pages_for(16 + 4, 4)
    small = pages_for(4 + 4, 4)
    budget = teng.num_pages - 1
    n = (budget - need) // small + 1          # promised + need > budget
    assert n * small + need - len(tshared) <= budget
    filler = _prompt(np.random.default_rng(10), 4)
    for r in range(n):
        jeng.submit(JRequest(rid=10 + r, prompt=filler, params=jsp))
        teng.submit(Request(rid=10 + r, prompt=filler, params=tsp))
    jadm = JAdmissionController(JServeConfig(**serve), jeng)
    tadm = AdmissionController(ServeConfig(**serve), teng)
    cold = (31 - prompt)[::-1].copy()
    for rid, p, want in ((1, prompt.copy(), OK), (2, cold, OVERLOADED)):
        a = jadm.check(JRequest(rid=rid, prompt=p, params=jsp), now_s=0.0)
        b = tadm.check(Request(rid=rid, prompt=p, params=tsp), now_s=0.0)
        assert (b.reason, b.detail) == (a.reason, a.detail) and \
            b.reason == want


# --------------------------------------------------------------------------
# telemetry


def test_percentile_exact_against_jax():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100, 1001):
        vals = list(rng.standard_normal(n))
        if n > 2:
            vals[1] = float("nan")
        for q in (0.0, 1.0, 37.5, 50.0, 99.0, 100.0):
            assert percentile(vals, q) == jpercentile(vals, q)
    assert math.isnan(percentile([], 50))
    assert math.isnan(percentile([float("nan")], 50))
    with pytest.raises(ValueError):
        percentile([1.0], 101)


def test_telemetry_snapshot_matches_jax():
    """The same outcomes into both ``ServeTelemetry`` (private registries,
    past the 4096-sample reservoir): identical snapshots and the same
    metric names."""
    rng = np.random.default_rng(1)
    treg, jreg = MetricsRegistry(enabled=True), \
        JMetricsRegistry(enabled=True)
    tel, jtel = ServeTelemetry(4, registry=treg), \
        JServeTelemetry(4, registry=jreg)
    for i in range(5000):
        n = int(rng.integers(1, 9))
        kw = dict(rid=i, tokens=np.arange(n, dtype=np.int32),
                  logps=np.zeros(n, np.float32),
                  finish_reason="expired" if i % 97 == 0 else "length",
                  prompt_len=int(rng.integers(1, 50)),
                  prefix_hit_tokens=int(rng.integers(0, 4)),
                  ttft_s=float(rng.exponential(0.05)),
                  latency_s=float(rng.exponential(0.5)))
        done = 10.0 + i * 0.01
        tel.record(GenerationResult(**kw), done_s=done)
        jtel.record(JGenerationResult(**kw), done_s=done)
    assert tel.snapshot() == jtel.snapshot()

    def names(text):
        return sorted(set(re.findall(r"^([a-z_]+)[{ ]", text, re.M)))

    assert names(treg.prometheus_text()) == names(jreg.prometheus_text())
    assert "serve_ttft_seconds_bucket" in treg.prometheus_text()


# --------------------------------------------------------------------------
# the front door


def _rl():
    return dict(temperature=1.0, top_k=0, top_p=1.0, max_new_tokens=5,
                engine="continuous")


def _door(tiny, **serve_kw):
    """``tests/test_serving.py::TestFrontDoor._door``, the port's."""
    _, _, tcfg, tp = tiny
    serve = _serve(port=0, max_total_tokens=16, **serve_kw)
    return FrontDoor(tcfg, tp, ServeConfig(**serve), rl=RLConfig(**_rl()),
                     vocab_limit=20, key=as_key(np.asarray(
                         jax.random.PRNGKey(3))))


def _jdoor(tiny):
    """The same, the reference's."""
    jcfg, jp, _, _ = tiny
    return JFrontDoor(jcfg, jp, JServeConfig(**_serve(
        port=0, max_total_tokens=16)), rl=JRLConfig(**_rl()),
        vocab_limit=20, key=jax.random.PRNGKey(3))


async def _http(port, method, path, payload=None, accept=""):
    """One request -> (status, headers, body): JSON, NDJSON lines of a
    chunked stream, or text."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps(payload).encode() if payload is not None else b""
    extra = f"Accept: {accept}\r\n" if accept else ""
    writer.write((f"{method} {path} HTTP/1.1\r\nHost: t\r\n{extra}"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    hdrs = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b""):
            break
        k, _, v = line.decode("latin1").partition(":")
        hdrs[k.strip().lower()] = v.strip()
    if hdrs.get("transfer-encoding") == "chunked":
        out = []
        while True:
            n = int((await reader.readline()).strip(), 16)
            if n == 0:
                break
            out.append(json.loads(await reader.readexactly(n)))
            await reader.readexactly(2)
    else:
        data = await reader.readexactly(int(hdrs.get("content-length", 0)))
        out = (data.decode() if "text/plain" in hdrs.get("content-type", "")
               else json.loads(data))
    writer.close()
    return status, hdrs, out


def _frame(payload: bytes, opcode: int = 0x1) -> bytes:
    mask = b"\x01\x02\x03\x04"
    n = len(payload)
    head = bytes([0x80 | opcode])
    head += bytes([0x80 | n]) if n < 126 else \
        bytes([0x80 | 126]) + n.to_bytes(2, "big")
    return head + mask + bytes(b ^ mask[i % 4] for i, b in enumerate(payload))


async def _ws(port, payloads):
    """Every payload on one websocket at once -> {id: [frames]} (token
    events, then the result or an error)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(b"GET /ws HTTP/1.1\r\nHost: t\r\nUpgrade: websocket\r\n"
                 b"Connection: Upgrade\r\n"
                 b"Sec-WebSocket-Key: dGVzdGtleTEyMzQ1Njc4\r\n\r\n")
    await writer.drain()
    assert b"101" in await reader.readline()
    while (await reader.readline()) not in (b"\r\n", b""):
        pass
    for p in payloads:
        writer.write(_frame(json.dumps(p).encode()))
    await writer.drain()
    frames = {p["id"]: [] for p in payloads}
    done = 0
    while done < len(payloads):
        hdr = await reader.readexactly(2)
        n = hdr[1] & 0x7F
        if n == 126:
            n = int.from_bytes(await reader.readexactly(2), "big")
        msg = json.loads(await reader.readexactly(n))
        frames[msg["id"]].append(msg)
        done += "finish_reason" in msg or "error" in msg
    writer.write(_frame(b"", opcode=0x8))
    await writer.drain()
    writer.close()
    return frames


async def _traffic(door):
    """The same sequence for either door: two plain requests, one NDJSON
    stream, three requests in flight on one websocket, in this order (so
    both doors assign the same rids)."""
    await door.start()
    try:
        port = door.port
        out = {}
        for i, toks in enumerate(([5, 6, 7, 8], [9, 4, 11])):
            st, _, out[f"http{i}"] = await _http(
                port, "POST", "/generate", {"tokens": toks,
                                            "max_new_tokens": 5})
            assert st == 200
        st, hdrs, lines = await _http(port, "POST", "/generate", {
            "tokens": [12, 13, 14, 15, 16], "max_new_tokens": 5,
            "stream": True})
        assert st == 200 and hdrs["content-type"] == "application/x-ndjson"
        out["ndjson"] = lines
        out["ws"] = await _ws(port, [
            {"id": f"w{j}", "tokens": [20 + j, 21, 22, 23 - j],
             "max_new_tokens": 5} for j in range(3)])
        return out
    finally:
        await door.close()


def test_front_door_matches_jax_over_http_ndjson_and_ws(tiny):
    jdoor, tdoor = _jdoor(tiny), _door(tiny)
    want = asyncio.run(_traffic(jdoor))
    got = asyncio.run(_traffic(tdoor))
    results = {}
    for name in ("http0", "http1"):
        results[name] = (got[name], want[name])
    *events, res = got["ndjson"]
    assert [e["token"] for e in events] == res["tokens"]
    assert [e["index"] for e in events] == list(range(len(events)))
    results["ndjson"] = (res, want["ndjson"][-1])
    for wid, frames in got["ws"].items():
        *events, res = frames
        assert all(f["id"] == wid for f in frames)
        assert [e["token"] for e in events] == res["tokens"]
        results[wid] = (res, want["ws"][wid][-1])
    for name, (b, a) in results.items():
        assert b["tokens"] == a["tokens"], name
        np.testing.assert_allclose(b["logps"], a["logps"], rtol=0,
                                   atol=TOL_LP, err_msg=name)
        assert (b["finish_reason"], b["prompt_len"],
                b["prefix_hit_tokens"]) == (a["finish_reason"],
                                            a["prompt_len"],
                                            a["prefix_hit_tokens"]), name
    assert sum(len(r[0]["tokens"]) for r in results.values()) > 6
    assert tdoor.telemetry.completed == jdoor.telemetry.completed == 6


def test_rejects_health_and_metrics(tiny, monkeypatch):
    """400 infeasible, 408 expired, 429 queue_full (the queue cap reached
    while a step is held), /healthz, and /metrics as JSON and as
    Prometheus text (no ``xla_compiles_total``: the port compiles nothing
    and counts new launch shapes instead, ``tests/test_torch_sentinel.py``
    holds those series)."""
    door = _door(tiny, max_queue=1)
    eng = door.engine
    gate = threading.Event()
    step = eng.step

    def held_step(*a, **k):
        gate.wait(30)
        return step(*a, **k)

    monkeypatch.setattr(eng, "step", held_step)

    async def scenario():
        await door.start()
        obs.configure(True, clear=True)
        port = door.port
        try:
            st, _, err = await _http(port, "POST", "/generate", {
                "tokens": list(range(4, 18)), "max_new_tokens": 5})
            assert (st, err["error"]) == (400, INFEASIBLE)   # 14 + 5 > 16
            st, _, err = await _http(port, "POST", "/generate", {
                "tokens": [5, 6], "max_new_tokens": 5, "deadline_s": 1e-9})
            assert (st, err["error"]) == (408, EXPIRED)
            first = asyncio.ensure_future(_http(
                port, "POST", "/generate", {"tokens": [5, 6, 7],
                                            "max_new_tokens": 5}))
            while not eng.has_work():
                await asyncio.sleep(0.005)
            # the pump is in a held step: the next two wait in its inbox
            second = asyncio.ensure_future(_http(
                port, "POST", "/generate", {"tokens": [8, 9],
                                            "max_new_tokens": 5}))
            third = asyncio.ensure_future(_http(
                port, "POST", "/generate", {"tokens": [10, 11],
                                            "max_new_tokens": 5}))
            while door._pending.qsize() < 2:
                await asyncio.sleep(0.005)
            gate.set()
            codes = [(await t)[0] for t in (first, second, third)]
            assert codes == [200, 200, 429]
            st, _, health = await _http(port, "GET", "/healthz")
            assert st == 200 and health["ok"]
            assert health["stats"]["completed"] == 2
            st, _, m = await _http(port, "GET", "/metrics")
            assert st == 200 and m["slo"]["completed"] == 2
            assert m["rejected"] == {INFEASIBLE: 1, EXPIRED: 1,
                                     QUEUE_FULL: 1, OVERLOADED: 0}
            assert m["engine"]["completed"] == 2
            st, hdrs, text = await _http(port, "GET",
                                         "/metrics?format=prometheus")
            assert st == 200 and "text/plain" in hdrs["content-type"]
            assert "# TYPE serve_requests_completed_total counter" in text
            assert "serve_requests_completed_total 2" in text
            assert "serve_ttft_seconds_bucket" in text
            assert "engine_free_pages" in text
            assert "xla_compiles_total" not in text
            st, _, text2 = await _http(port, "GET", "/metrics",
                                       accept="text/plain")
            assert "serve_ttft_seconds_bucket" in text2
            st, _, _ = await _http(port, "GET", "/nowhere")
            assert st == 404
        finally:
            gate.set()
            obs.configure(False, clear=True)
            await door.close()

    asyncio.run(scenario())


def test_scrape_answers_from_the_host_while_a_step_runs(tiny, monkeypatch):
    """While ``engine.step`` is held on the executor thread, /healthz and
    /metrics (both formats) answer from host state: the event loop's
    thread reads no tensor (no ``.item``/``.cpu``/``.tolist``/``.numpy``)
    and waits for no step; the request then completes."""
    door = _door(tiny)
    eng = door.engine
    gate, entered = threading.Event(), threading.Event()
    step = eng.step

    def held_step(*a, **k):
        entered.set()
        gate.wait(30)
        return step(*a, **k)

    monkeypatch.setattr(eng, "step", held_step)
    readers = set()
    for name in ("item", "cpu", "tolist", "numpy"):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, **k):
            readers.add(threading.get_ident())
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, wrapped)
    loop_thread = threading.get_ident()

    async def scenario():
        await door.start()
        obs.configure(True, clear=True)
        try:
            port = door.port
            req = asyncio.ensure_future(_http(
                port, "POST", "/generate", {"tokens": [5, 6, 7, 8],
                                            "max_new_tokens": 5}))
            while not entered.is_set():
                await asyncio.sleep(0.005)
            readers.clear()
            for path, accept in (("/healthz", ""), ("/metrics", ""),
                                 ("/metrics", "text/plain")):
                st, _, body = await asyncio.wait_for(
                    _http(port, "GET", path, accept=accept), timeout=10)
                assert st == 200, path
            assert loop_thread not in readers
            assert not gate.is_set()              # the step is still held
            _, _, m = await _http(port, "GET", "/metrics")
            assert m["slo"]["completed"] == 0
            assert m["engine"]["submitted"] == 1
            gate.set()
            st, _, res = await req
            assert st == 200 and len(res["tokens"]) >= 1
        finally:
            gate.set()
            obs.configure(False, clear=True)
            await door.close()

    asyncio.run(scenario())


def test_front_door_contracts(tiny):
    jcfg, jp, tcfg, tp = tiny
    # tests/test_serving.py::TestEngineProtocol: both engines are Engines
    for kind in ("continuous", "static"):
        eng = build_engine(tcfg, tp, ServeConfig(**_serve(engine=kind)),
                           rl=RLConfig(**_rl()))
        assert isinstance(eng, Engine)
    with pytest.raises(ValueError, match="continuous engine"):
        FrontDoor(tcfg, tp, ServeConfig(**_serve(engine="static")),
                  rl=RLConfig(**_rl()))
    door = _door(tiny)
    with pytest.raises(ValueError, match="profile"):
        door.build_request({"tokens": [5], "temperature": 0.5}, 0.0)
    with pytest.raises(ValueError, match="tokens"):
        door.build_request({}, 0.0)
    req = door.build_request({"tokens": [5, 6], "deadline_s": 2.0,
                              "priority": 0}, 10.0)
    assert (req.rid, req.deadline_s, req.priority, req.arrival_s) == \
        (0, 12.0, 0, 10.0)
    for kw in ({"max_queue": 0}, {"queue_overcommit": 0.5}):
        with pytest.raises(ValueError):
            ServeConfig(**kw)
        with pytest.raises(ValueError):
            JServeConfig(**kw)


def test_serve_cli_listen_on_cpu():
    """``launch/serve.py --listen`` on the CPU at smoke size: it prints
    the port it took, answers a text request through the arithmetic
    tokenizer, and stops on SIGINT."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--listen",
         "--device", "cpu", "--smoke", "--port", "0", "--max-new", "4",
         "--prompt-len", "16", "--slots", "2", "--page-size", "4"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        m = re.search(r"listening on 127\.0\.0\.1:(\d+)", line)
        assert m, (line, proc.stderr.read() if proc.poll() is not None
                   else "")
        port = int(m.group(1))
        st, _, res = asyncio.run(_http(port, "POST", "/generate", {
            "text": "12+7=", "max_new_tokens": 4}))
        assert st == 200 and 1 <= len(res["tokens"]) <= 4
        st, _, health = asyncio.run(_http(port, "GET", "/healthz"))
        assert st == 200 and health["stats"]["completed"] == 1
    finally:
        proc.send_signal(2)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, proc.stderr.read()
