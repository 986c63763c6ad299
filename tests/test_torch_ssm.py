"""The port's Mamba2 family against the JAX package: the SSD functions,
the Mamba2 block, the model with and without a cache, the static engine,
the recompute through K6's twin, and the engine's static fallback.

Inputs come from numpy with a seed; the model's params are the JAX
package's ``init_params`` carried across with ``params_from_numpy``.
Tolerances, all float32: ``ssd_chunked`` 1e-3 and ``ssd_reference`` /
``ssd_decode_step`` 1e-4, as in the JAX package's own
``tests/test_attention_ssm.py`` (the chunked form and the recurrence sum
in other orders); the head-sliced gradient 1e-4 (the same, summed over a
backward); the Mamba2 block 1e-5 relative to its largest output; logits
1e-4 (logits reach ~300 with the tied, scale-1 embeddings of random
weights: a few float32 ulps); logps 1e-5 (as the static engine's tests).
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import RLConfig as JRLConfig
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import ssm as jssm
from repro.models.params import param_templates as jtemplates
from repro.sampling.engine import StaticEngine as JStaticEngine
from repro.sampling.engine import token_logps as jtoken_logps
from repro.serving.api import Request as JRequest
from repro.serving.api import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs
from repro_torch.config import RLConfig, ServeConfig
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, param_templates,
                                params_from_numpy)
from repro_torch.models import ssm
from repro_torch.sampling import StaticEngine, build_engine, generate
from repro_torch.sampling import token_logps
from repro_torch.sampling.prng import PRNGKey
from repro_torch.serving.api import Request, SamplingParams

ROOT = Path(__file__).resolve().parents[1]
ARCH = "mamba2-1.3b"
GREEDY = dict(temperature=1.0, top_k=1, top_p=1.0)
PROMPT = 40                      # 2.5 smoke chunks of 16: a padded chunk


def _ssd_inputs(shape, seed=0):
    b, s, h, p, g, n = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bb = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, g, n)).astype(np.float32)
    init = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, a, bb, cc, init


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("chunk", [16, 32, 96])
@pytest.mark.parametrize("head_slice", [0, 1, 2])
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunked_matches_jax(chunk, head_slice, g):
    """Head slices of one and two heads over one or two B/C groups reach
    every slicing path (shared b/c, per-slice groups, per-head
    expansion); S 96 with chunk 32 and 96, and a padded chunk at 16."""
    *arrs, init = _ssd_inputs((2, 96, 4, 16, g, 8), seed=chunk + g)
    y, st = ssm.ssd_chunked(*_t(arrs), chunk=chunk,
                            init_state=torch.from_numpy(init),
                            head_slice=head_slice)
    jy, jst = jssm.ssd_chunked(*_j(arrs), chunk=chunk,
                               init_state=jnp.asarray(init),
                               head_slice=head_slice)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-3,
                               atol=1e-3)
    y0, s0 = jssm.ssd_reference(*_j(arrs), init_state=jnp.asarray(init))
    np.testing.assert_allclose(y.numpy(), np.asarray(y0), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(st.numpy(), np.asarray(s0), rtol=1e-3,
                               atol=1e-3)


def test_ssd_reference_and_decode_step_match_jax():
    *arrs, init = _ssd_inputs((2, 33, 4, 8, 2, 4), seed=5)
    y, st = ssm.ssd_reference(*_t(arrs), init_state=torch.from_numpy(init))
    jy, jst = jssm.ssd_reference(*_j(arrs), init_state=jnp.asarray(init))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-4,
                               atol=1e-4)
    x, dt, a, bb, cc = arrs
    st2, y_t = ssm.ssd_decode_step(torch.from_numpy(init), *_t(
        (x[:, 0], dt[:, 0], a, bb[:, 0], cc[:, 0])))
    jst2, jy_t = jssm.ssd_decode_step(jnp.asarray(init), *_j(
        (x[:, 0], dt[:, 0], a, bb[:, 0], cc[:, 0])))
    np.testing.assert_allclose(st2.numpy(), np.asarray(jst2), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(jy_t), rtol=1e-4,
                               atol=1e-4)


def test_decode_continues_the_chunked_state():
    *arrs, _ = _ssd_inputs((1, 33, 2, 8, 1, 4), seed=6)
    x, dt, a, bb, cc = _t(arrs)
    _, st = ssm.ssd_chunked(x[:, :32], dt[:, :32], a, bb[:, :32], cc[:, :32],
                            chunk=8)
    st2, y_t = ssm.ssd_decode_step(st, x[:, 32], dt[:, 32], a, bb[:, 32],
                                   cc[:, 32])
    y_ref, st_ref = ssm.ssd_reference(x, dt, a, bb, cc)
    torch.testing.assert_close(y_t, y_ref[:, 32], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st2, st_ref, rtol=1e-4, atol=1e-4)


def test_grad_through_head_slices():
    """The gradient through checkpointed head slices equals the gradient
    without slices, and the JAX package's."""
    *arrs, _ = _ssd_inputs((1, 32, 4, 8, 1, 4), seed=7)
    x, dt, a, bb, cc = _t(arrs)
    grads = []
    for hs in (0, 2):
        xg = x.clone().requires_grad_()
        y, _ = ssm.ssd_chunked(xg, dt, a, bb, cc, chunk=8, head_slice=hs)
        y.sum().backward()
        grads.append(xg.grad)
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-4, atol=1e-4)
    jx, jdt, ja, jb, jc = _j(arrs)
    jg = jax.grad(lambda v: jssm.ssd_chunked(v, jdt, ja, jb, jc, chunk=8,
                                             head_slice=2)[0].sum())(jx)
    np.testing.assert_allclose(grads[1].numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-4)


# --------------------------------------------------------------------------
# the model


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, port cfg, port params) of the smoke config."""
    jcfg = jconfigs.smoke(ARCH)
    tcfg = tconfigs.smoke(ARCH)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jcfg, jp, tcfg, tp


@functools.lru_cache(maxsize=None)
def _jax_fns(jcfg, b, max_len):
    """The reference's jitted prefill with a cache, decode step and
    ``token_logps`` for one config, built once."""
    @jax.jit
    def prefill(p, toks):
        cache = jinit_cache(jcfg, p, b, max_len)
        logits, cache, _ = jforward(jcfg, p, toks, cache=cache)
        return logits, cache

    step = jax.jit(lambda p, c, tok, pos: jdecode_step(jcfg, p, c, tok, pos))
    logps = jax.jit(lambda p, t: jtoken_logps(jcfg, p, t))
    return prefill, step, logps


def _prompts(vocab, b, n=PROMPT, seed=0):
    return np.random.default_rng(seed).integers(3, vocab, (b, n)
                                                ).astype(np.int32)


def test_config_and_templates_match_jax():
    full = tconfigs.get_config(ARCH)
    ref = jconfigs.get_config(ARCH)
    port_only = ("paged_attn_impl", "ssd_impl")
    for f in dataclasses.fields(full):
        if f.name not in port_only:
            assert getattr(full, f.name) == getattr(ref, f.name), f.name
    assert (full.d_inner, full.ssm_heads) == (ref.d_inner, ref.ssm_heads)
    # the port also counts the final norm
    assert full.param_count() == ref.param_count() + full.d_model
    assert round(full.param_count() / 1e9, 3) == 1.344
    cfg = tconfigs.smoke(ARCH)
    shapes = jax.tree_util.tree_map(
        lambda t: t.shape, jtemplates(jconfigs.smoke(ARCH)),
        is_leaf=lambda x: hasattr(x, "shape") and hasattr(x, "init"))
    got = jax.tree_util.tree_map(
        lambda t: t.shape, param_templates(cfg),
        is_leaf=lambda x: hasattr(x, "shape") and hasattr(x, "init"))
    assert got == shapes
    with pytest.raises(ValueError, match="ssd_impl"):
        tconfigs.smoke(ARCH, ssd_impl="kernel")


def test_init_params_draws_the_ssm_initializers():
    """A = exp(A_log) in [1, 16) and softplus(dt_bias) in [1e-3, 1e-1],
    drawn per layer (the JAX package's ``ssm_a`` / ``ssm_dt``)."""
    cfg = tconfigs.smoke(ARCH, num_layers=4)
    m = init_params(cfg, 0, device="cpu")["blocks"]["layer_0"]["mamba"]
    a = m["A_log"].exp()
    dtb = torch.nn.functional.softplus(m["dt_bias"])
    assert a.shape == (4, cfg.ssm_heads)
    assert float(a.min()) >= 1.0 - 1e-5 and float(a.max()) < 16.0
    assert float(dtb.min()) >= 1e-3 - 1e-7 and float(dtb.max()) <= 1e-1 + 1e-6
    assert not torch.equal(a[0], a[1])
    assert torch.equal(m["D"], torch.ones_like(m["D"]))
    assert "ffn_norm" not in init_params(cfg, 0, device="cpu")["blocks"][
        "layer_0"]


def test_bf16_params_carry_across_unchanged():
    jcfg = jconfigs.smoke(ARCH, dtype="bfloat16")
    jp = jinit_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    for name in ("A_log", "D", "dt_bias", "conv_w", "in_proj"):
        got = tp["blocks"]["layer_0"]["mamba"][name]
        want = np.asarray(jp["blocks"]["layer_0"]["mamba"][name])
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32))


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_mamba_block_matches_jax(model, impl):
    """One Mamba2 block without a cache, through the chunked SSD or K6's
    twin (S 40: the twin runs on a padded last chunk)."""
    jcfg, jp, tcfg, tp = model
    h = np.random.default_rng(8).standard_normal(
        (2, PROMPT, tcfg.d_model)).astype(np.float32)
    jpl = jax.tree_util.tree_map(lambda t: t[0],
                                 jp["blocks"]["layer_0"]["mamba"])
    tpl = {k: v[0] for k, v in tp["blocks"]["layer_0"]["mamba"].items()}
    want, _ = jssm.mamba_block(jcfg, jpl, jnp.asarray(h))
    want = np.asarray(want)
    ss.reset_launch_counts()
    got = ssm.mamba_block(dataclasses.replace(tcfg, ssd_impl=impl), tpl,
                          torch.from_numpy(h))
    assert ss.LAUNCHES["ssd_scan"] == 0            # the twin, on the CPU
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)


def test_forward_cache_and_decode_match_jax(model):
    jcfg, jp, tcfg, tp = model
    b, steps = 2, 3
    prompts = _prompts(tcfg.vocab_size, b)
    want = np.asarray(jforward(jcfg, jp, jnp.asarray(prompts))[0])
    got, _, _ = forward(tcfg, tp, torch.from_numpy(prompts))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)

    jprefill, jstep, _ = _jax_fns(jcfg, b, PROMPT + steps)
    jlogits, jcache = jprefill(jp, jnp.asarray(prompts))
    cache = init_cache(tcfg, tp, b, PROMPT + steps)
    logits, out, _ = forward(tcfg, tp, torch.from_numpy(prompts), cache=cache)
    assert out is cache
    want = np.asarray(jlogits)  # noqa: RA003
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-4, atol=1e-4)
    for n in ("conv", "ssm"):
        tc = cache["layer_0"]["ssm_c"][n]
        jc = np.asarray(jcache["layer_0"]["ssm_c"][n])  # noqa: RA003
        assert tuple(tc.shape) == jc.shape
        assert tc.dtype == (torch.float32 if n == "ssm" else
                            getattr(torch, tcfg.dtype))
        np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-4, atol=1e-4)
    tok = np.argmax(want[:, -1], -1).astype(np.int32)
    for t in range(steps):
        jl, jcache = jstep(jp, jcache, jnp.asarray(tok), jnp.int32(PROMPT + t))
        tl, _ = decode_step(tcfg, tp, cache, torch.from_numpy(tok), PROMPT + t)
        want = np.asarray(jl)  # noqa: RA003
        np.testing.assert_allclose(tl.numpy(), want, rtol=1e-4, atol=1e-4)
        tok = np.argmax(want, -1).astype(np.int32)
    np.testing.assert_allclose(
        cache["layer_0"]["ssm_c"]["ssm"].numpy(),
        np.asarray(jcache["layer_0"]["ssm_c"]["ssm"]),  # noqa: RA003
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("vocab_limit", [None, 3])
def test_static_engine_matches_jax_greedy(model, vocab_limit):
    """Tokens equal, logps within 1e-4, per-request budgets trimmed; with
    a vocab limit of 3 (PAD, BOS, EOS) these prompts make one row finish
    at EOS and the others run to their budget."""
    jcfg, jp, tcfg, tp = model
    prompts = _prompts(tcfg.vocab_size, 3, seed=2)
    budgets = (8, 5, 8)
    jeng = JStaticEngine(jcfg, jp, rl=JRLConfig(**GREEDY),
                         vocab_limit=vocab_limit)
    jres = jeng.generate([JRequest(rid=i, prompt=p, params=JSamplingParams(
        max_new_tokens=n, **GREEDY)) for i, (p, n) in
        enumerate(zip(prompts, budgets))])
    tres = StaticEngine(tcfg, tp, rl=RLConfig(**GREEDY),
                        vocab_limit=vocab_limit).generate(
        [Request(rid=i, prompt=p, params=SamplingParams(
            max_new_tokens=n, **GREEDY)) for i, (p, n) in
         enumerate(zip(prompts, budgets))])
    for a, b, n in zip(jres, tres, budgets):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_allclose(b.logps, a.logps, rtol=0, atol=1e-4)
        assert (b.rid, b.finish_reason, b.prompt_len) == \
            (a.rid, a.finish_reason, a.prompt_len)
        assert b.gen_count <= n
    if vocab_limit == 3:
        assert {r.finish_reason for r in tres} == {"eos", "length"}


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_token_logps_matches_jax(model, impl):
    jcfg, jp, tcfg, tp = model
    toks = _prompts(tcfg.vocab_size, 2, n=PROMPT + 9, seed=2)
    want = _jax_fns(jcfg, 2, PROMPT + 9)[2](jp, jnp.asarray(toks))
    ss.reset_launch_counts()
    got = token_logps(dataclasses.replace(tcfg, ssd_impl=impl), tp,
                      torch.from_numpy(toks))
    assert ss.LAUNCHES["ssd_scan"] == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_pallas_raises_under_grad_and_keeps_the_cache_path(model):
    _, _, tcfg, tp = model
    cfg = dataclasses.replace(tcfg, ssd_impl="pallas")
    toks = torch.from_numpy(_prompts(tcfg.vocab_size, 2, seed=3))
    emb = {**tp, "embed": tp["embed"].clone().requires_grad_()}
    with pytest.raises(RuntimeError, match="forward-only"):
        forward(cfg, emb, toks)
    # a prefill that fills a cache keeps the chunked SSD (it needs the
    # final state): the same logits and state as ssd_impl="chunked"
    caches = {}
    for c in (cfg, tcfg):
        caches[c.ssd_impl] = init_cache(c, tp, 2, PROMPT + 1)
        forward(c, tp, toks, cache=caches[c.ssd_impl])
    torch.testing.assert_close(caches["pallas"]["layer_0"]["ssm_c"]["ssm"],
                               caches["chunked"]["layer_0"]["ssm_c"]["ssm"],
                               rtol=0, atol=0)


def test_continuous_engine_falls_back_to_static(model):
    """As the JAX package: ``build_engine`` and the legacy ``generate``
    warn and serve static for an architecture the paged cache cannot
    serve; ``generate`` names the continuous-engine kwargs it ignores."""
    _, _, tcfg, tp = model
    rl = RLConfig(temperature=1.0, top_k=0, top_p=1.0, max_new_tokens=5)
    with pytest.warns(UserWarning, match="serving static"):
        eng = build_engine(tcfg, tp, ServeConfig(engine="continuous"), rl=rl)
    assert isinstance(eng, StaticEngine)
    prompts = _prompts(tcfg.vocab_size, 2, seed=4)
    want = generate(tcfg, rl, tp, prompts, key=PRNGKey(3))
    with pytest.warns(UserWarning, match=r"ignoring \['num_slots'\]"):
        got = generate(tcfg, rl, tp, prompts, key=PRNGKey(3),
                       engine="continuous", num_slots=2)
    assert torch.equal(got["tokens"], want["tokens"])
    res = eng.generate([Request(rid=i, prompt=p, params=SamplingParams.from_rl(
        rl)) for i, p in enumerate(prompts)], key=PRNGKey(3))
    for i, r in enumerate(res):
        np.testing.assert_array_equal(
            want["completions"][i, :r.gen_count].numpy(), r.tokens)


def test_serve_cli_mamba2_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--smoke", "--arch", ARCH, "--engine", "continuous",
         "--batch", "3", "--prompt-len", "40", "--max-new", "4",
         "--rounds", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "serving static" in out.stderr
    assert "engine=static attn=naive batch=3" in out.stdout, out.stdout
    assert "total 12 tokens" in out.stdout, out.stdout
