"""Trace/metrics exporters: Chrome-trace (Perfetto) JSON and JSONL.

The tracer records events with float-second timestamps and logical
*track* names; export maps tracks onto Chrome-trace ``tid`` integers
(first-seen order) with ``thread_name`` metadata so Perfetto labels each
timeline "learner", "sampler-0", "engine", … Timestamps convert to the
format's microseconds.

``validate_chrome_trace`` is the smoke-test half: it re-parses an
exported file and checks the structural contract Perfetto needs
(``traceEvents`` list; every event carries ``name``/``ph``/``ts``;
duration events carry ``dur``; async events carry ``id``), returning the
event count so callers can assert non-emptiness.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List

from repro_torch.obs.trace import Tracer

_DUR_PH = {"X"}
_ASYNC_PH = {"b", "n", "e"}


def chrome_trace(tracer: Tracer, process_name: str = "repro"
                 ) -> Dict[str, Any]:
    """The tracer's events as a Chrome-trace JSON object."""
    tids: Dict[str, int] = {}
    out: List[Dict[str, Any]] = []
    for ev in tracer.events():
        track = str(ev.get("track", "main"))
        tid = tids.get(track)
        if tid is None:
            tid = tids[track] = len(tids) + 1
        ce: Dict[str, Any] = {"name": ev["name"], "ph": ev["ph"],
                              "ts": round(ev["ts"] * 1e6, 3),
                              "pid": 1, "tid": tid}
        if "dur" in ev:
            ce["dur"] = round(ev["dur"] * 1e6, 3)
        if "id" in ev:
            ce["id"] = ev["id"]
        if "cat" in ev:
            ce["cat"] = ev["cat"]
        if ev["ph"] == "i":
            ce["s"] = "t"                # instant scope: thread
        if ev.get("args"):
            ce["args"] = {k: v for k, v in ev["args"].items()}
        out.append(ce)
    meta: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
         "args": {"name": process_name}}]
    for track, tid in tids.items():
        meta.append({"name": "thread_name", "ph": "M", "pid": 1,
                     "tid": tid, "args": {"name": track}})
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def write_chrome_trace(tracer: Tracer, path: str,
                       process_name: str = "repro") -> int:
    """Write the Perfetto-loadable trace file; returns the event count
    (excluding metadata)."""
    obj = chrome_trace(tracer, process_name)
    with open(path, "w") as f:
        json.dump(obj, f)
    return sum(1 for e in obj["traceEvents"] if e["ph"] != "M")


def write_jsonl(tracer: Tracer, path: str) -> int:
    """One JSON object per line, raw tracer vocabulary (float seconds,
    track names) — the grep/pandas-friendly event log."""
    events = tracer.events()
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")
    return len(events)


def validate_chrome_trace(path: str) -> int:
    """Parse ``path`` and check the Chrome-trace structural contract;
    returns the non-metadata event count. Raises ``ValueError`` on any
    malformation (the CI smoke gate for exported traces)."""
    with open(path) as f:
        obj = json.load(f)
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError(f"{path}: not a Chrome-trace object "
                         "(missing traceEvents)")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError(f"{path}: traceEvents is not a list")
    n = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"{path}: event {i} is not an object")
        for field in ("name", "ph"):
            if field not in ev:
                raise ValueError(f"{path}: event {i} missing {field!r}")
        ph = ev["ph"]
        if ph == "M":
            continue
        n += 1
        if "ts" not in ev:
            raise ValueError(f"{path}: event {i} ({ev['name']}) missing ts")
        if not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"{path}: event {i} ts not numeric")
        if ph in _DUR_PH and not isinstance(ev.get("dur"), (int, float)):
            raise ValueError(f"{path}: duration event {i} ({ev['name']}) "
                             "missing numeric dur")
        if ph in _ASYNC_PH and "id" not in ev:
            raise ValueError(f"{path}: async event {i} ({ev['name']}) "
                             "missing id")
    return n
