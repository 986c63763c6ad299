"""The launch-shape sentinel: the port of ``repro.analysis.sentinel``.

The bound functions equal the reference's (and the port's own width
rules: ``sampling.continuous._live_width``, ``sampling.spec.
verify_width_buckets``). ``RecompileSentinel`` counts new launch shapes
(the first dispatch in the process of a kernel route at a new shape
signature), the eager port's stand-in for an XLA compile, so the
reference's recompile tests (``tests/test_recompile.py::
TestEngineExecutableBound``) run on the port's ``ContinuousEngine``
(``paged_attn_impl="ref"``): a cold mixed-length epoch stays within the
analytic bound, a steady epoch adds nothing, speculative rounds of
varying acceptance add nothing once warm. The bound here has no eager
slack: the port counts kernel dispatches only, where XLA also compiles
one-off scatters. The front door's ``/metrics`` carries the counters.
"""
import asyncio

import numpy as np
import pytest
import torch

from repro.analysis import sentinel as jsentinel
from repro_torch import obs
from repro_torch.analysis import sentinel
from repro_torch.analysis.sentinel import (RecompileSentinel,
                                           executable_bound,
                                           pow2_bucket_count,
                                           prefill_executable_bound,
                                           spec_verify_executable_bound,
                                           spec_verify_width_buckets)
from repro_torch.config import ATTN, MLP, ModelConfig, RLConfig, ServeConfig
from repro_torch.models import init_params
from repro_torch.sampling import ContinuousEngine
from repro_torch.sampling.continuous import _live_width
from repro_torch.sampling.prng import PRNGKey
from repro_torch.sampling.spec import verify_width_buckets
from repro_torch.serving.api import Request, SamplingParams
from repro_torch.serving.server import FrontDoor

TINY = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=64,
                   num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=32,
                   block_pattern=(ATTN,), ffn_pattern=(MLP,),
                   dtype="float32", attn_impl="naive", remat=False,
                   rope_theta=1e4, paged_attn_impl="ref")
NUM_SLOTS = 4
PREFILL_CHUNK = 4
# tests/test_recompile.py's mix: 1..5 pages of a page_size=4 pool
WORKLOAD = [(3, 4), (7, 8), (12, 6), (5, 8), (20, 8), (9, 3), (15, 8),
            (4, 8)]


@pytest.fixture(autouse=True)
def _fresh_process_view():
    """Each test sees the process as if no kernel had launched yet (other
    test files on this worker launch the same shapes)."""
    torch.set_num_threads(1)
    sentinel._seen.clear()
    yield


def test_bounds_equal_the_reference():
    for pages in range(1, 1025):
        assert pow2_bucket_count(pages) == jsentinel.pow2_bucket_count(pages)
        assert executable_bound(pages) == jsentinel.executable_bound(pages)
        assert executable_bound(pages, phases=2, slack=0) == \
            jsentinel.executable_bound(pages, phases=2, slack=0)
        for chunk in (None, 0, 1, 4, 512):
            assert prefill_executable_bound(chunk, pages) == \
                jsentinel.prefill_executable_bound(chunk, pages)
    for k in range(9):
        assert spec_verify_width_buckets(k) == \
            jsentinel.spec_verify_width_buckets(k) == verify_width_buckets(k)
        for pages in (1, 2, 3, 7, 8, 16, 100, 1024):
            assert spec_verify_executable_bound(k, pages) == \
                jsentinel.spec_verify_executable_bound(k, pages)


def test_bounds_follow_the_engines_width_rules():
    for cap in (1, 2, 3, 7, 8, 16, 100, 1024):
        assert pow2_bucket_count(cap) == len(
            {_live_width(n, cap) for n in range(1, cap + 1)})
    for k in range(9):
        # _spec_round's window: max(2, _live_width(1 + drafts, k + 1))
        assert spec_verify_width_buckets(k) == len(
            {max(2, _live_width(1 + d, k + 1)) for d in range(k + 1)})
    assert pow2_bucket_count(8) == 4 and pow2_bucket_count(1024) == 11
    assert executable_bound(1024, phases=2, slack=0) == 22


def _engine(spec_k=0, top_k=0):
    rl = RLConfig(temperature=1.0, top_k=top_k, top_p=1.0, max_new_tokens=8)
    params = init_params(TINY, 0, device="cpu")
    eng = ContinuousEngine(TINY, params, rl=rl, max_total_tokens=32,
                           num_slots=NUM_SLOTS, page_size=4, sync_every=2,
                           prefill_chunk=PREFILL_CHUNK, vocab_limit=20,
                           prefix_cache=False, spec_k=spec_k,
                           key=PRNGKey(1))
    return eng, rl


def _epoch(eng, rl, rid0):
    rng = np.random.default_rng(0)
    reqs = [Request(rid=rid0 + i, prompt=rng.integers(3, 20, size=plen),
                    params=SamplingParams.from_rl(rl, max_new=mnew))
            for i, (plen, mnew) in enumerate(WORKLOAD)]
    return eng.generate(reqs, key=PRNGKey(2))


def test_mixed_lengths_bucketed_then_steady_zero():
    eng, rl = _engine()
    bound = (pow2_bucket_count(eng.pages_per_slot)
             + prefill_executable_bound(PREFILL_CHUNK, eng.pages_per_slot))
    with RecompileSentinel("cold") as cold:
        r1 = _epoch(eng, rl, rid0=0)
    assert cold.compiles > 0
    cold.assert_bound(bound, "cold mixed-length epoch")
    assert {e[:2] for e in cold.events} == {("paged_decode", "twin"),
                                            ("paged_prefill", "twin")}
    decode = [e for e in cold.events if e[0] == "paged_decode"]
    assert len(decode) <= pow2_bucket_count(eng.pages_per_slot)
    assert all(e[2] == NUM_SLOTS for e in decode)      # every slot decodes
    with RecompileSentinel("steady") as steady:
        r2 = _epoch(eng, rl, rid0=100)
    steady.assert_bound(0, "steady-state epoch")
    assert len(r1) == len(WORKLOAD) and len(r2) == len(WORKLOAD)
    assert all(len(r.tokens) >= 1 for r in r1 + r2)


def test_nested_sentinels_each_count_what_they_see():
    eng, rl = _engine()
    with RecompileSentinel("outer") as outer:
        with RecompileSentinel("inner") as inner:
            _epoch(eng, rl, rid0=0)
        n = inner.compiles
        assert n > 0
        sentinel.record_launch("flash_attention", "twin", 1, 7, 7)
    assert outer.compiles == n + 1 and inner.compiles == n
    assert outer.events[-1] == ("flash_attention", "twin", 1, 7, 7)


def test_spec_varying_acceptance_steady_zero():
    """Greedy (top_k 1): both epochs emit the same streams, so the same
    verify and table widths; the verify chunks key on (pow2 verify width,
    pow2 table width) only."""
    eng, rl = _engine(spec_k=4, top_k=1)
    bound = (spec_verify_executable_bound(4, eng.pages_per_slot)
             + prefill_executable_bound(PREFILL_CHUNK, eng.pages_per_slot))
    with RecompileSentinel("spec-cold") as cold:
        r1 = _epoch(eng, rl, rid0=0)
    assert cold.compiles > 0
    cold.assert_bound(bound, "spec cold epoch")
    with RecompileSentinel("spec-steady") as steady:
        r2 = _epoch(eng, rl, rid0=100)
    steady.assert_bound(0, "spec steady-state epoch")
    st = eng.stats()
    assert st["spec_rounds"] > 0 and st["drafted_tokens_total"] > 0
    assert len(r1) == len(WORKLOAD) and len(r2) == len(WORKLOAD)


def test_assert_bound_raises():
    s = RecompileSentinel("x")
    s.compiles = 3
    with pytest.raises(AssertionError, match="3 new launch shapes"):
        s.assert_bound(2)
    s.assert_bound(3)


def test_front_door_metrics_carry_the_launch_series():
    """The door installs the listener: after a request, ``/metrics`` as
    Prometheus text counts the paged kernels' dispatches and new launch
    shapes, by kernel and route."""
    params = init_params(TINY, 0, device="cpu")
    door = FrontDoor(TINY, params, ServeConfig(
        num_slots=2, page_size=4, sync_every=4, max_total_tokens=16, port=0),
        rl=RLConfig(temperature=1.0, top_k=0, top_p=1.0, max_new_tokens=5,
                    engine="continuous"), vocab_limit=20, key=PRNGKey(3))

    async def scenario():
        await door.start()
        obs.configure(True, clear=True)
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           door.port)
            body = b'{"tokens": [5, 6, 7], "max_new_tokens": 5}'
            writer.write(b"POST /generate HTTP/1.1\r\nHost: t\r\n"
                         b"Content-Length: %d\r\n\r\n" % len(body) + body)
            await writer.drain()
            assert b" 200 " in await reader.readline()
            writer.close()
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           door.port)
            writer.write(b"GET /metrics HTTP/1.1\r\nHost: t\r\n"
                         b"Accept: text/plain\r\nContent-Length: 0\r\n\r\n")
            await writer.drain()
            return (await reader.read()).decode()
        finally:
            obs.configure(False, clear=True)
            await door.close()
    text = asyncio.run(scenario())
    assert "# TYPE kernel_launches_total counter" in text
    assert "# TYPE kernel_launch_shapes_total counter" in text
    for kernel in ("paged_decode", "paged_prefill"):
        assert (f'kernel_launch_shapes_total{{kernel="{kernel}",'
                f'route="twin"}}') in text
    # the series by its labels: other engines of the process may have
    # added series of other routes, which sort anywhere
    launches = [line for line in text.splitlines()
                if line.startswith('kernel_launches_total{kernel='
                                   '"paged_decode",route="twin"}')]
    assert launches and float(launches[0].split()[-1]) > 0


def test_a_launch_is_recorded_on_the_twin_route_as_on_the_kernel():
    """``kernels.ops`` records at its dispatch, whichever route it takes:
    a CPU call counts what a card call counts, under its route's name."""
    from repro_torch.kernels import ops
    q = torch.zeros(1, 5, 2, 16)
    with RecompileSentinel() as s:
        ops.flash_attention(q, q, q)
        ops.flash_attention(q, q, q)
        ops.fused_token_logprob(torch.zeros(3, 4, 8),
                                torch.zeros(3, 4, dtype=torch.long))
        ops.fused_token_logprob(torch.zeros(3, 4, 8),
                                torch.zeros(3, 4, dtype=torch.long),
                                impl="naive")
    assert s.events == [("flash_attention", "twin", 1, 5, 5),
                        ("fused_token_logprob", "twin", 12),
                        ("fused_token_logprob", "naive", 12)]
