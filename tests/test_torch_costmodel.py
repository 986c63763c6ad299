"""The dry-run's arithmetic against the JAX package, value for value: the
input shapes and the long-context gate, ``param_count(active_only=)``,
the cost model (``flops_estimate``, ``bytes_estimate``), ``model_flops``,
``roofline`` on the H100's constants, and the optimizer and
grad-accumulation choices, for every registry arch x input shape x
{256, 512} ranks.

The port's ``ModelConfig.param_count`` counts more than the reference's
(the final norm, the QKV biases, an encoder-decoder model's
cross-attention and norms; ROADMAP queue 3): the difference is pinned
here, and the cost model runs on its own copy of the reference's count
(``costmodel.reference_param_count``), so its numbers equal the
reference's.
"""
import math

import pytest

from repro import config as jconfig
from repro import configs as jconfigs
from repro.launch import costmodel as jcost
from repro.launch import roofline as jroof
from repro.launch import step_fns as jsf
from repro_torch import config as tconfig
from repro_torch import configs as tconfigs
from repro_torch.launch import costmodel as tcost
from repro_torch.launch import roofline as troof
from repro_torch.launch import step_fns as tsf
from repro_torch.parallel import mesh as tmesh

ARCHS = sorted(jconfigs.ALL)
RTOL = 1e-12


def _close(a, b):
    assert math.isclose(a, b, rel_tol=RTOL, abs_tol=0.0), (a, b)


def test_shapes_and_gate_equal_the_reference():
    assert tconfig.INPUT_SHAPES == tuple(
        tconfig.ShapeConfig(s.name, s.seq_len, s.global_batch, s.kind)
        for s in jconfig.INPUT_SHAPES)
    assert [tuple(vars(s).values()) for s in tconfig.INPUT_SHAPES] == \
        [tuple(vars(s).values()) for s in jconfig.INPUT_SHAPES]
    assert list(tconfig.SHAPES_BY_NAME) == list(jconfig.SHAPES_BY_NAME)
    assert tconfigs.LONG_CONTEXT_OK == jconfigs.LONG_CONTEXT_OK
    assert sorted(tconfigs.ALL) == ARCHS
    for arch in ARCHS:
        for s in jconfig.INPUT_SHAPES:
            assert tconfigs.supports_shape(arch, s.name) == \
                jconfigs.supports_shape(arch, s.name)


def _extra(cfg):
    """What the port's count adds to the reference's (ROADMAP queue 3)."""
    d, h = cfg.d_model, cfg.head_dim
    n_q, n_kv = cfg.num_heads, cfg.num_kv_heads
    attn = d * (n_q * h) + 2 * d * (n_kv * h) + (n_q * h) * d
    extra = d                                        # the final norm
    for li in range(cfg.num_layers):
        kind = cfg.block_pattern[li % cfg.period]
        if kind in ("attn", "local", "cross"):
            if cfg.qkv_bias and kind != "cross":
                extra += (n_q + 2 * n_kv) * h
            if cfg.is_encdec:
                extra += attn + d
    if cfg.encoder_layers:
        # the encoder's final norm; the reference counts its attention as
        # 4 d (n_q h), equal to the port's where n_kv == n_q
        extra += d + cfg.encoder_layers * (
            attn - 4 * d * (n_q * h))
    return extra


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for active in (False, True):
        ref = j.param_count(active_only=active)
        assert tcost.reference_param_count(t, active_only=active) == ref
        assert t.param_count(active_only=active) - _extra(t) == ref
    if t.num_experts:
        assert t.param_count(active_only=True) < t.param_count()
    else:
        assert t.param_count(active_only=True) == t.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_cost_model_equals_the_reference(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert tsf.optimizer_for(t) == jsf.optimizer_for(j)
    assert tsf.grad_accum_for(t) == jsf.grad_accum_for(j)
    for js in jconfig.INPUT_SHAPES:
        ts = tconfig.SHAPES_BY_NAME[js.name]
        for ideal in (False, True):
            _close(tcost.flops_estimate(t, ts, ideal=ideal),
                   jcost.flops_estimate(j, js, ideal=ideal))
        _close(troof.model_flops(t, ts), jroof.model_flops(j, js))
        for n_dev in (256, 512):
            for opt in ("adamw", "adafactor"):
                got = tcost.bytes_estimate(t, ts, n_dev, optimizer=opt)
                want = jcost.bytes_estimate(j, js, n_dev, optimizer=opt)
                assert list(got) == list(want)
                for k in want:
                    _close(got[k], want[k])
            flops = tcost.flops_estimate(t, ts) / n_dev
            byt = tcost.bytes_estimate(t, ts, n_dev)["total"]
            terms = troof.roofline(flops, byt, 1e9)
            _close(terms["compute_s"], flops / 989e12)
            _close(terms["memory_s"], byt / 3.35e12)
            _close(terms["collective_s"], 1e9 / 450e9)
            assert terms["bottleneck"] == max(
                (terms["compute_s"], "compute"), (terms["memory_s"], "memory"),
                (terms["collective_s"], "collective"))[1]


def test_roofline_runs_on_the_h100_constants():
    assert (tmesh.PEAK_BF16_FLOPS, tmesh.HBM_BW, tmesh.ICI_BW) == \
        (989e12, 3.35e12, 450e9)
    assert tmesh.HBM_BYTES == 80 * 10 ** 9
    terms = troof.roofline(989e12, 0.0, 0.0)
    assert terms == {"compute_s": 1.0, "memory_s": 0.0, "collective_s": 0.0,
                     "bottleneck": "compute"}
    assert troof.fmt_row("x", terms) == jroof.fmt_row("x", terms)


def test_abstract_inputs_have_the_reference_shapes():
    """The meta tensors stand where the reference's ShapeDtypeStructs do:
    the same tree, shapes and dtypes (on every arch with its memory, SSM
    and MoE leaves)."""
    import jax
    import jax.numpy as jnp
    for arch in ("whisper-small", "jamba-1.5-large-398b",
                 "llama-3.2-vision-11b", "gemma2-9b"):
        j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
        pairs = [(jsf.abstract_batch(j, jconfig.TRAIN_4K),
                  tsf.abstract_batch(t, tconfig.TRAIN_4K)),
                 (jsf.abstract_cache(j, 4, 64), tsf.abstract_cache(t, 4, 64)),
                 (jsf.abstract_state(j), tsf.abstract_state(t))]
        for jt, tt in pairs:
            jl = jax.tree_util.tree_leaves(jt)
            tl = jax.tree_util.tree_leaves(tt)
            assert len(jl) == len(tl), arch
            for a, b in zip(jl, tl):
                assert b.device.type == "meta"
                assert tuple(a.shape) == tuple(b.shape), arch
                want = str(jnp.dtype(a.dtype))
                assert str(b.dtype).replace("torch.", "") == want, arch
