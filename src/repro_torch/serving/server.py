"""Asyncio serving front door: HTTP + websocket streaming over the
continuous engine. The port of ``repro/serving/server.py``.

One process, one engine, one event loop. Client requests land in an
asyncio queue; a single *pump* coroutine owns the engine — it drains the
queue through admission control, submits survivors, and runs
``engine.step()`` in a worker thread (the card's work and the host's
launches release the GIL there while the loop keeps accepting
connections). Each step's :class:`~repro_torch.serving.api.TokenEvent`
batch is fanned out to per-request subscriber queues, which the
connection handlers stream from.

Endpoints (deliberately tiny, stdlib-only — no web framework):

- ``POST /generate`` — body ``{"tokens": [...]}`` or ``{"text": "..."}``
  plus optional ``max_new_tokens`` / ``temperature`` / ``top_k`` /
  ``top_p`` (must match the engine profile) / ``priority`` /
  ``deadline_s`` (relative to arrival) / ``stream``. Non-streaming
  returns one JSON result; ``"stream": true`` returns chunked NDJSON —
  one line per token event, then a result line.
- ``GET /ws`` (websocket upgrade) — send the same JSON request as a text
  frame, receive one JSON event per frame; multiple requests may be in
  flight per connection (responses carry the request ``id`` echoed back).
- ``GET /healthz`` — liveness + engine stats.
- ``GET /metrics`` — SLO telemetry (p50/p99 TTFT, tokens/s/slot),
  admission rejections, prefix-cache counters; Prometheus text of the
  ``repro_torch.obs`` registry on ``Accept: text/plain`` or
  ``?format=prometheus``.

Admission rejections map to HTTP status codes the client can act on:
400 ``infeasible`` (never retry as-is), 408 ``expired``, 429
``queue_full`` / ``overloaded`` (back off and retry).

Threads and the card: ``engine.step`` is the only code that touches the
card, and it runs on the executor thread (the default CUDA stream). The
loop thread admits, submits, pops results and answers ``/healthz`` and
``/metrics`` from host-side state only (the scheduler's counters, the
allocator, the obs registry): it launches nothing and reads no device
tensor, so a scrape never waits for a step. Admission and submission run
between steps, in the pump, so they never race the scheduler.

On a live ``serve`` plan (``plan=``) the door is one rank of the plan:
rank 0 runs the loop above, and every other rank follows its engine
rounds in lockstep (``FrontDoor.follow``).

The door installs ``analysis.sentinel``'s metrics listener, as the
reference does: ``/metrics`` counts every kernel dispatch
(``kernel_launches_total``) and every new launch shape
(``kernel_launch_shapes_total``, the eager port's stand-in for the
reference's ``xla_compiles_total``: a steady-state new shape is an
operator page, not just a test failure).
"""
from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import struct
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.analysis.sentinel import install_metrics_listener
from repro_torch.config import ModelConfig, RLConfig, ServeConfig
from repro_torch.parallel.collectives import broadcast_object
from repro_torch.sampling.continuous import ContinuousEngine
from repro_torch.sampling.engine import build_engine
from repro_torch.serving.admission import (EXPIRED, INFEASIBLE,
                                           AdmissionController)
from repro_torch.serving.api import GenerationResult, Request, SamplingParams
from repro_torch.serving.telemetry import ServeTelemetry

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
_REJECT_STATUS = {INFEASIBLE: 400, EXPIRED: 408}   # others -> 429


def _ws_accept(key: str) -> str:
    digest = hashlib.sha1((key + _WS_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def _ws_frame(payload: bytes, opcode: int = 0x1) -> bytes:
    """Server->client frame (FIN set, unmasked)."""
    head = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([n])
    elif n < 1 << 16:
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    return head + payload


async def _ws_read_frame(reader: asyncio.StreamReader
                         ) -> Tuple[int, bytes]:
    """One client frame -> (opcode, unmasked payload)."""
    b1, b2 = await reader.readexactly(2)
    opcode = b1 & 0x0F
    masked, n = b2 & 0x80, b2 & 0x7F
    if n == 126:
        n = struct.unpack(">H", await reader.readexactly(2))[0]
    elif n == 127:
        n = struct.unpack(">Q", await reader.readexactly(8))[0]
    mask = await reader.readexactly(4) if masked else b"\x00" * 4
    data = bytearray(await reader.readexactly(n))
    for i in range(len(data)):
        data[i] ^= mask[i % 4]
    return opcode, bytes(data)


class FrontDoor:
    """The serving front door: engine pump + HTTP/websocket endpoints.
    Serves on the device ``params`` live on; ``key`` keys the engine's
    draws (default ``PRNGKey(0)``).

    ``plan`` (default the plan of ``ServeConfig.mesh``, as
    ``build_engine`` takes it) is the ``serve`` plan of the engine. On a
    live one every rank builds the door together; rank 0 (``leader``)
    runs the asyncio server and admits, and every other rank runs
    ``follow``: before each engine step rank 0 broadcasts "step", and
    every rank steps its engine in the same lockstep (the engine
    broadcasts rank 0's submissions and clock with the round); while idle
    it broadcasts "idle" every ``HEARTBEAT_S``, so no rank waits out a
    collective's timeout; ``close`` broadcasts "stop", which ends the
    followers."""

    HEARTBEAT_S = 1.0

    def __init__(self, cfg: ModelConfig, params, serve: ServeConfig, *,
                 rl: Optional[RLConfig] = None, tokenizer=None,
                 vocab_limit: Optional[int] = None, plan=None,
                 key=None) -> None:
        self.serve = serve
        self.rl = rl or RLConfig(engine="continuous")
        self.tokenizer = tokenizer
        self.engine = build_engine(cfg, params, serve, rl=self.rl,
                                   vocab_limit=vocab_limit, plan=plan,
                                   key=key)
        if not isinstance(self.engine, ContinuousEngine):
            raise ValueError("the front door streams from the continuous "
                             f"engine; ServeConfig.engine={serve.engine!r} "
                             "resolved to a non-streaming engine")
        mesh = self.engine.plan.mesh
        self._mesh = mesh if mesh.live else None
        self.leader = self._mesh is None or mesh.rank == 0
        self.admission = AdmissionController(serve, self.engine)
        self.telemetry = ServeTelemetry(serve.num_slots)
        install_metrics_listener()
        self._pending: asyncio.Queue = asyncio.Queue()
        self._subs: Dict[int, asyncio.Queue] = {}
        self._next_rid = 0
        self._server: Optional[asyncio.AbstractServer] = None
        self._pump_task: Optional[asyncio.Task] = None
        self._running = False

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        if not self.leader:
            raise RuntimeError("rank 0 of the plan runs the server; every "
                               "other rank runs FrontDoor.follow()")
        self._running = True
        self._pump_task = asyncio.ensure_future(self._pump())
        self._server = await asyncio.start_server(
            self._handle_conn, self.serve.host, self.serve.port)

    @property
    def port(self) -> int:
        assert self._server is not None, "front door not started"
        return self._server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        self._running = False
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if self._pump_task is not None:
            await self._pump_task
        if self._mesh is not None:           # the followers' last command
            await asyncio.get_event_loop().run_in_executor(
                None, broadcast_object, "stop", self._mesh)

    def follow(self) -> None:
        """A rank other than 0 of a live plan: step the engine whenever
        rank 0 says "step", until it says "stop"."""
        if self.leader:
            raise RuntimeError("rank 0 runs the server (start), not follow")
        while True:
            cmd = broadcast_object(None, self._mesh)
            if cmd == "stop":
                return
            if cmd == "step":
                for ev in self.engine.step():
                    if ev.finished:              # rank 0 answers clients
                        self.engine.pop_result(ev.rid)

    def _step(self):
        """One engine round (on the executor thread), announced to the
        followers first on a live plan."""
        if self._mesh is not None:
            broadcast_object("step", self._mesh)
        return self.engine.step()

    # -- request intake ----------------------------------------------------
    def build_request(self, payload: Dict[str, Any],
                      now_s: float) -> Request:
        """A validated Request from a client JSON payload. Raises
        ValueError on anything malformed (mapped to HTTP 400)."""
        tokens = payload.get("tokens")
        if tokens is None:
            text = payload.get("text")
            if text is None or self.tokenizer is None:
                raise ValueError('payload needs "tokens" (or "text" when '
                                 "the server has a tokenizer)")
            tokens = self.tokenizer.encode(text)
        rl = self.rl
        params = SamplingParams(
            temperature=payload.get("temperature", rl.temperature),
            top_k=payload.get("top_k", rl.top_k),
            top_p=payload.get("top_p", rl.top_p),
            max_new_tokens=payload.get("max_new_tokens",
                                       rl.max_new_tokens))
        if params.profile != self.engine.profile:
            raise ValueError(f"sampling profile {params.profile} != engine "
                             f"profile {self.engine.profile} — this "
                             "deployment serves one profile")
        deadline = None
        rel = payload.get("deadline_s", self.serve.default_deadline_s or None)
        if rel:
            deadline = now_s + float(rel)
        rid, self._next_rid = self._next_rid, self._next_rid + 1
        return Request(rid=rid, prompt=np.asarray(tokens, np.int32),
                       params=params,
                       priority=int(payload.get("priority",
                                                self.serve.default_priority)),
                       deadline_s=deadline, arrival_s=now_s)

    async def submit(self, req: Request) -> asyncio.Queue:
        """Queue a request for the pump; returns its subscriber queue.
        Items are ("reject", AdmissionDecision) | ("event", TokenEvent) |
        ("done", GenerationResult)."""
        sub: asyncio.Queue = asyncio.Queue()
        await self._pending.put((req, sub))
        return sub

    # -- the engine pump ---------------------------------------------------
    def _admit(self, req: Request, sub: asyncio.Queue) -> None:
        decision = self.admission.check(req, now_s=time.perf_counter())
        if not decision:
            sub.put_nowait(("reject", decision))
            return
        self._subs[req.rid] = sub
        self.engine.submit(req)

    async def _pump(self) -> None:
        loop = asyncio.get_event_loop()
        beat = time.perf_counter()
        while self._running:
            while not self._pending.empty():
                req, sub = self._pending.get_nowait()
                self._admit(req, sub)
            if not self.engine.has_work():
                try:                     # park until work (or shutdown poll)
                    req, sub = await asyncio.wait_for(self._pending.get(),
                                                      timeout=0.05)
                    self._admit(req, sub)
                except asyncio.TimeoutError:
                    pass
                if self._mesh is not None and \
                        time.perf_counter() - beat > self.HEARTBEAT_S:
                    await loop.run_in_executor(None, broadcast_object,
                                               "idle", self._mesh)
                    beat = time.perf_counter()
                continue
            events = await loop.run_in_executor(None, self._step)
            beat = time.perf_counter()
            now = time.perf_counter()
            for ev in events:
                sub = self._subs.get(ev.rid)
                if sub is not None and not ev.finished:
                    sub.put_nowait(("event", ev))
                if ev.finished:
                    res = self.engine.pop_result(ev.rid)
                    self.telemetry.record(res, done_s=now)
                    if sub is not None:
                        sub.put_nowait(("done", res))
                        self._subs.pop(ev.rid, None)

    # -- HTTP plumbing -----------------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            head = await reader.readline()
            if not head:
                return
            try:
                method, path, _ = head.decode("latin1").split()
            except ValueError:
                await self._respond(writer, 400, {"error": "bad request"})
                return
            path, _, query = path.partition("?")
            headers: Dict[str, str] = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode("latin1").partition(":")
                headers[k.strip().lower()] = v.strip()
            if headers.get("upgrade", "").lower() == "websocket":
                await self._handle_ws(reader, writer, headers)
            elif method == "GET" and path == "/healthz":
                await self._respond(writer, 200,
                                    {"ok": True, "stats": self.engine.stats()})
            elif method == "GET" and path == "/metrics":
                accept = headers.get("accept", "")
                if ("format=prometheus" in query or "text/plain" in accept
                        or "openmetrics" in accept):
                    await self._respond_text(writer,
                                             obs.metrics.prometheus_text())
                else:                       # back-compat JSON snapshot
                    await self._respond(writer, 200, self.metrics())
            elif method == "POST" and path == "/generate":
                body = await reader.readexactly(
                    int(headers.get("content-length", "0")))
                await self._handle_generate(writer, body)
            else:
                await self._respond(writer, 404, {"error": f"no {path}"})
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    def metrics(self) -> Dict[str, Any]:
        return {"slo": self.telemetry.snapshot(),
                "rejected": dict(self.admission.rejected),
                "engine": self.engine.stats()}

    @staticmethod
    async def _respond(writer: asyncio.StreamWriter, status: int,
                       obj: Dict[str, Any]) -> None:
        body = json.dumps(obj).encode()
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  408: "Request Timeout", 429: "Too Many Requests"}.get(
                      status, "Error")
        writer.write(f"HTTP/1.1 {status} {reason}\r\n"
                     "Content-Type: application/json\r\n"
                     f"Content-Length: {len(body)}\r\n"
                     "Connection: close\r\n\r\n".encode() + body)
        await writer.drain()

    @staticmethod
    async def _respond_text(writer: asyncio.StreamWriter, text: str) -> None:
        body = text.encode()
        writer.write("HTTP/1.1 200 OK\r\n"
                     "Content-Type: text/plain; version=0.0.4; "
                     "charset=utf-8\r\n"
                     f"Content-Length: {len(body)}\r\n"
                     "Connection: close\r\n\r\n".encode() + body)
        await writer.drain()

    async def _handle_generate(self, writer: asyncio.StreamWriter,
                               body: bytes) -> None:
        try:
            payload = json.loads(body or b"{}")
            req = self.build_request(payload, time.perf_counter())
        except (ValueError, TypeError) as e:
            await self._respond(writer, 400, {"error": str(e)})
            return
        sub = await self.submit(req)
        if not payload.get("stream"):
            result = await self._collect(sub, writer)
            if result is not None:
                await self._respond(writer, 200, _result_json(result))
            return
        # chunked NDJSON streaming
        first = await sub.get()
        if first[0] == "reject":
            await self._reject_response(writer, first[1])
            return
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: application/x-ndjson\r\n"
                     b"Transfer-Encoding: chunked\r\n"
                     b"Connection: close\r\n\r\n")
        item = first
        while True:
            kind, val = item
            if kind == "event":
                line = json.dumps({"token": val.token, "logp": val.logp,
                                   "index": val.index}).encode() + b"\n"
            else:                                   # done
                line = json.dumps(_result_json(val)).encode() + b"\n"
            writer.write(f"{len(line):x}\r\n".encode() + line + b"\r\n")
            await writer.drain()
            if kind == "done":
                break
            item = await sub.get()
        writer.write(b"0\r\n\r\n")
        await writer.drain()

    async def _collect(self, sub: asyncio.Queue,
                       writer: asyncio.StreamWriter
                       ) -> Optional[GenerationResult]:
        while True:
            kind, val = await sub.get()
            if kind == "reject":
                await self._reject_response(writer, val)
                return None
            if kind == "done":
                return val

    async def _reject_response(self, writer: asyncio.StreamWriter,
                               decision) -> None:
        status = _REJECT_STATUS.get(decision.reason, 429)
        await self._respond(writer, status,
                            {"error": decision.reason,
                             "detail": decision.detail})

    # -- websocket ---------------------------------------------------------
    async def _handle_ws(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter,
                         headers: Dict[str, str]) -> None:
        key = headers.get("sec-websocket-key", "")
        writer.write(("HTTP/1.1 101 Switching Protocols\r\n"
                      "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                      f"Sec-WebSocket-Accept: {_ws_accept(key)}\r\n\r\n"
                      ).encode())
        await writer.drain()
        send_lock = asyncio.Lock()

        async def send_json(obj: Dict[str, Any]) -> None:
            async with send_lock:
                writer.write(_ws_frame(json.dumps(obj).encode()))
                await writer.drain()

        async def stream(sub: asyncio.Queue, client_id: Any) -> None:
            while True:
                kind, val = await sub.get()
                if kind == "reject":
                    await send_json({"id": client_id, "error": val.reason,
                                     "detail": val.detail})
                    return
                if kind == "event":
                    await send_json({"id": client_id, "token": val.token,
                                     "logp": val.logp, "index": val.index})
                else:
                    await send_json({"id": client_id,
                                     **_result_json(val)})
                    return

        tasks = []
        try:
            while True:
                opcode, data = await _ws_read_frame(reader)
                if opcode == 0x8:                   # close
                    writer.write(_ws_frame(data, opcode=0x8))
                    await writer.drain()
                    break
                if opcode == 0x9:                   # ping -> pong
                    writer.write(_ws_frame(data, opcode=0xA))
                    await writer.drain()
                    continue
                if opcode not in (0x1, 0x2):
                    continue
                try:
                    payload = json.loads(data)
                    req = self.build_request(payload, time.perf_counter())
                except (ValueError, TypeError) as e:
                    await send_json({"id": None, "error": "bad_request",
                                     "detail": str(e)})
                    continue
                sub = await self.submit(req)
                tasks.append(asyncio.ensure_future(
                    stream(sub, payload.get("id", req.rid))))
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            if tasks:
                await asyncio.gather(*tasks, return_exceptions=True)


def _result_json(res: GenerationResult) -> Dict[str, Any]:
    return {"tokens": [int(t) for t in res.tokens],
            "logps": [float(v) for v in res.logps],
            "finish_reason": res.finish_reason,
            "prompt_len": res.prompt_len,
            "prefix_hit_tokens": res.prefix_hit_tokens,
            "ttft_s": res.ttft_s, "latency_s": res.latency_s}


async def serve_forever(cfg: ModelConfig, params, serve: ServeConfig,
                        **kwargs) -> None:
    """Construct a FrontDoor and run until cancelled. On a live plan
    (``plan=`` or ``ServeConfig.mesh``) rank 0 serves and every other rank
    follows it until it stops."""
    door = FrontDoor(cfg, params, serve, **kwargs)
    if not door.leader:
        await asyncio.get_event_loop().run_in_executor(None, door.follow)
        return
    await door.start()
    print(f"[serving] listening on {serve.host}:{door.port} "
          f"(engine={serve.engine}, slots={serve.num_slots}, "
          f"pages={door.engine.num_pages})", flush=True)
    try:
        while True:
            await asyncio.sleep(3600)
    finally:
        await door.close()
