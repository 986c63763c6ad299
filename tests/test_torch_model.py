"""Params, layers and the paged-cache model of the PyTorch port against the
JAX package.

Both packages get the same weights (the JAX package's ``init_params``,
carried across with ``params_from_numpy``) and the same numpy-seeded pools
and tokens; the JAX side runs with ``paged_attn_impl="ref"``. float32,
tolerance 1e-4 abs on logits (different matmul and softmax summation
order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import ATTN as JATTN
from repro.config import LOCAL as JLOCAL
from repro.config import MLP as JMLP
from repro.config import ModelConfig as JModelConfig
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models.params import param_templates as jtemplates
from repro.sampling.paged_cache import init_paged_pool as jinit_pool
from repro_torch import configs as tconfigs
from repro_torch.config import ModelConfig as TModelConfig
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params)
from repro_torch.models import layers as tlayers
from repro_torch.models import param_templates, params_from_numpy
from repro_torch.models import model as model_mod
from repro_torch.sampling.paged_cache import SCRATCH_PAGE, init_paged_pool

GQA_LOCAL = dict(name="gqa-local", family="dense", num_layers=4, d_model=64,
                 num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=32,
                 sliding_window=8, dtype="float32", attn_impl="naive",
                 remat=False, rope_theta=1e4)


def _configs(name):
    if name == "gqa-local":
        j = JModelConfig(block_pattern=(JATTN, JLOCAL), ffn_pattern=(JMLP,),
                         paged_attn_impl="ref", **GQA_LOCAL)
        t = TModelConfig(block_pattern=("attn", "local"), ffn_pattern=("mlp",),
                         paged_attn_impl="ref", **GQA_LOCAL)
        return j, t
    return (jconfigs.smoke(name, paged_attn_impl="ref"),
            tconfigs.smoke(name, paged_attn_impl="ref"))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _paired_pools(jcfg, tcfg, num_pages, page_size, seed):
    """Identical random pools (NaN in scratch page 0) for both packages."""
    rng = np.random.default_rng(seed)
    jpool = jinit_pool(jcfg, num_pages, page_size)
    tpool = init_paged_pool(tcfg, num_pages, page_size, device="cpu")
    for li in jpool:
        for name in ("kp", "vp"):
            shape = jpool[li]["self"][name].shape
            arr = rng.standard_normal(shape).astype(np.float32)
            arr[:, 0] = np.nan
            jpool[li]["self"][name] = jnp.asarray(arr)
            tpool[li]["self"][name].copy_(torch.from_numpy(arr))
    return jpool, tpool


def _assert_pools_equal(jpool, tpool):
    """Every page but scratch page 0, which the JAX package never writes
    and the port takes dead-slot writes into."""
    for li in jpool:
        for name in ("kp", "vp"):
            np.testing.assert_allclose(
                tpool[li]["self"][name].numpy()[:, 1:],
                np.asarray(jpool[li]["self"][name])[:, 1:], atol=1e-5,
                rtol=0)


class TestParams:
    def test_templates_match_jax(self):
        jcfg, tcfg = _configs("qwen3-1.7b")
        want = jax.tree_util.tree_map(
            lambda t: t.shape, jtemplates(jcfg),
            is_leaf=lambda x: hasattr(x, "shape") and hasattr(x, "init"))
        got = jax.tree_util.tree_map(
            lambda t: t.shape, param_templates(tcfg),
            is_leaf=lambda x: hasattr(x, "shape") and hasattr(x, "init"))
        assert got == want

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_params_from_numpy_round_trip(self, dtype):
        jcfg, _ = _configs("qwen3-1.7b")
        jp = jinit_params(dataclasses.replace(jcfg, dtype=dtype),
                          jax.random.PRNGKey(1))
        tree = _np_tree(jp)
        tp = params_from_numpy(tree, device="cpu")
        want_dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        flat_np = jax.tree_util.tree_leaves(tree)
        flat_t = jax.tree_util.tree_leaves(
            tp, is_leaf=lambda x: isinstance(x, torch.Tensor))
        assert len(flat_np) == len(flat_t)
        for a, t in zip(flat_np, flat_t):
            assert t.dtype == want_dt and tuple(t.shape) == a.shape
            if dtype == "bfloat16":   # same 16-bit words, never upcast
                np.testing.assert_array_equal(
                    t.view(torch.int16).numpy().view(np.uint16),
                    a.view(np.uint16))
            else:
                np.testing.assert_array_equal(t.numpy(), a)

    def test_init_params_seeded_and_shaped(self):
        _, tcfg = _configs("qwen3-1.7b")
        a = init_params(tcfg, 3, device="cpu")
        b = init_params(tcfg, 3, device="cpu")
        c = init_params(tcfg, 4, device="cpu")
        assert torch.equal(a["embed"], b["embed"])
        assert not torch.equal(a["embed"], c["embed"])
        assert a["blocks"]["layer_0"]["attn"]["wq"].shape == (
            tcfg.num_blocks, tcfg.d_model, tcfg.num_heads * tcfg.head_dim)
        assert a["embed"].dtype == torch.float32
        bf = init_params(tcfg, 3, device="cpu", dtype=torch.bfloat16)
        assert bf["lm_head"].dtype == torch.bfloat16

    def test_cuda_request_without_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: a CUDA request is valid here")
        _, tcfg = _configs("qwen3-1.7b")
        with pytest.raises(RuntimeError, match="cuda"):
            init_params(tcfg, 0)              # default device is cuda


class TestLayers:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_layers_match_jax(self, dtype):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
        scale = rng.standard_normal((16,)).astype(np.float32)
        pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
        tol = 1e-2 if dtype == "bfloat16" else 1e-5
        pairs = [
            (jlayers.rmsnorm(jx, jnp.asarray(scale, jdt)),
             tlayers.rmsnorm(tx, torch.from_numpy(scale).to(tdt))),
            (jlayers.rope(jx, jnp.asarray(pos), 1e4),
             tlayers.rope(tx, torch.from_numpy(pos), 1e4)),
            (jlayers.softcap(jx, 2.5), tlayers.softcap(tx, 2.5)),
        ]
        w = {k: rng.standard_normal(s).astype(np.float32) * 0.2
             for k, s in (("w_gate", (16, 8)), ("w_up", (16, 8)),
                          ("w_down", (8, 16)))}
        pairs.append((jlayers.swiglu(jx, {k: jnp.asarray(v, jdt)
                                          for k, v in w.items()}),
                      tlayers.swiglu(tx, {k: torch.from_numpy(v).to(tdt)
                                          for k, v in w.items()})))
        for want, got in pairs:
            assert got.dtype == tdt
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       atol=tol, rtol=tol)


class TestPagedModel:
    @pytest.mark.parametrize("name", ["qwen3-1.7b", "gqa-local"])
    def test_prefill_then_decode_match_jax(self, name):
        jcfg, tcfg = _configs(name)
        jp = jinit_params(jcfg, jax.random.PRNGKey(0))
        tp = params_from_numpy(_np_tree(jp), device="cpu")
        page, width = 4, 6
        jpool, tpool = _paired_pools(jcfg, tcfg, 1 + 2 * width + 2, page,
                                     seed=1)
        table = np.array([[3, 5, 7, 9, 11, 13], [2, 4, 6, 8, 10, 12]],
                         np.int32)
        rng = np.random.default_rng(2)
        c = 7
        tokens = rng.integers(3, jcfg.vocab_size, (2, c)).astype(np.int32)
        positions = (np.array([[0], [5]]) + np.arange(c)).astype(np.int32)
        jl, jpool, _ = jforward(jcfg, jp, jnp.asarray(tokens),
                                positions=jnp.asarray(positions),
                                cache=jpool, page_table=jnp.asarray(table))
        tl, tpool, _ = forward(tcfg, tp, torch.from_numpy(tokens).long(),
                               positions=torch.from_numpy(positions),
                               cache=tpool,
                               page_table=torch.from_numpy(table))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        _assert_pools_equal(jpool, tpool)
        tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
        pos = positions[:, -1] + 1
        oob = width * page
        for i in range(6):
            step_pos = pos + i
            if i == 3:                 # slot 0 dead: its write is dropped
                step_pos = np.array([oob, pos[1] + i], np.int32)
            jlg, jpool = jdecode_step(jcfg, jp, jpool, jnp.asarray(tok),
                                      jnp.asarray(step_pos),
                                      page_table=jnp.asarray(table))
            tlg, tpool = decode_step(tcfg, tp, tpool,
                                     torch.from_numpy(tok).long(),
                                     torch.from_numpy(step_pos),
                                     page_table=torch.from_numpy(table))
            live = slice(1, 2) if i == 3 else slice(None)
            np.testing.assert_allclose(tlg.numpy()[live],
                                       np.asarray(jlg)[live], atol=1e-4,
                                       rtol=0)
            tok = np.asarray(jlg).argmax(-1).astype(np.int32)
        _assert_pools_equal(jpool, tpool)

    def test_dead_slot_decode_writes_nowhere(self):
        """Nowhere a request could own: the writes go to the scratch page,
        which the allocator never hands out and every reader masks."""
        assert model_mod.SCRATCH_PAGE == SCRATCH_PAGE
        _, tcfg = _configs("qwen3-1.7b")
        tp = init_params(tcfg, 0, device="cpu")
        page, width = 4, 3
        pool = init_paged_pool(tcfg, 8, page, device="cpu")
        gen = torch.Generator().manual_seed(0)
        for layer in pool.values():
            for leaf in layer["self"].values():
                leaf.copy_(torch.randn(leaf.shape, generator=gen))
                leaf[:, 0] = float("nan")
        before = {(li, n): leaf.clone() for li, layer in pool.items()
                  for n, leaf in layer["self"].items()}
        table = torch.tensor([[1, 2, 3], [0, 0, 0]], dtype=torch.int32)
        oob = width * page
        decode_step(tcfg, tp, pool, torch.tensor([5, 6]),
                    torch.tensor([oob, oob]), page_table=table)
        for (li, n), old in before.items():
            new = pool[li]["self"][n][:, SCRATCH_PAGE + 1:]
            old = old[:, SCRATCH_PAGE + 1:]
            assert torch.equal(new.view(torch.int32), old.view(torch.int32))

    def test_forward_without_paged_cache_raises(self):
        """A cache that is neither page pools with a page_table nor the
        dense cache of ``init_cache`` without one raises; cache=None is
        the dense path."""
        _, tcfg = _configs("qwen3-1.7b")
        tp = init_params(tcfg, 0, device="cpu")
        toks = torch.zeros((1, 4), dtype=torch.long)
        bad = {"layer_0": {"self": {"x": torch.zeros(1)}}}
        with pytest.raises(ValueError, match="paged"):
            forward(tcfg, tp, toks, cache=bad)
        with pytest.raises(ValueError, match="paged"):
            decode_step(tcfg, tp, init_cache(tcfg, tp, 1, 8), toks[:, 0], 0,
                        page_table=torch.zeros((1, 1), dtype=torch.int32))
        logits, cache, _ = forward(tcfg, tp, toks)
        assert cache is None and logits.shape == (1, 4, tcfg.padded_vocab)
