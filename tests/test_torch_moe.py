"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe.moe_ffn``.

Inputs are made with numpy from a seed and handed to both in float32.
The routers are built so that each case's routing is known: token t's
input is its first choice's router column (scaled so that its logit
leads by ~3) plus, for top-2, half of its second choice's, plus noise.
Cases: top-1 with a shared expert (Llama-4's layout), top-2 with
renormalised gates, and four experts where an expert other than the last
overflows at the minimum capacity of 4 (a decode step's). In all three
the last expert stays under its capacity, where the reference's dispatch
is sound, so the routing (expert ids, each entry's rank in its expert,
the kept set) is held exactly, and y and the aux metrics to float32
summation order (1e-5 relative, 1e-6 absolute). Gradients through both
(the router through the gates, the experts, the shared expert, the input)
are held at 1e-4 relative and 1e-6 absolute.

Where the last expert overflows, the reference zeroes one kept row more
than it reports dropping (its scatter writes every dropped entry as a
zero row onto the real slot (E-1, C-1)): ``test_last_expert_overflow``
pins that known reference fault, with the port dropping exactly the
entries of rank >= C.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_moe_ref import moe_ffn_kept
from repro.config import ModelConfig as JModelConfig
from repro.models import moe as jmoe
from repro_torch.config import ModelConfig
from repro_torch.models import moe

BASE = dict(name="moe-unit", family="moe", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=64,
            block_pattern=("attn",), ffn_pattern=("moe",), num_experts=4,
            dtype="float32")
# case -> (experts per token, shared expert, each token's first choice,
# each token's second choice or None); the order of the tokens is shuffled
CASES = {
    # 32 tokens, cap int(32 / 4 * 1.25) = 10: expert 0 takes 14 (4 drop)
    "top1_shared": (1, True, [0] * 14 + [1] * 8 + [2] * 6 + [3] * 4, None),
    # 32 x 2 entries, cap 20: expert 1 takes 26 (6 drop), expert 3 takes 8
    "top2": (2, False, [1] * 20 + [0] * 8 + [2] * 4,
             [0] * 6 + [2] * 8 + [3] * 6 + [1] * 6 + [3] * 2 + [0] * 4),
    # 8 tokens, cap max(int(8 / 4 * 1.25), 4) = 4: expert 2 takes 6
    "overflow_not_last": (1, False, [2] * 6 + [0, 1], None),
}


def _cfgs(k, shared):
    kw = dict(BASE, experts_per_token=k, shared_expert=shared)
    return JModelConfig(**kw), ModelConfig(**kw)


def _weights(rng, cfg):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    w = {"router": rng.standard_normal((d, e)),
         "w_gate": rng.standard_normal((e, d, f)) * 0.1,
         "w_up": rng.standard_normal((e, d, f)) * 0.1,
         "w_down": rng.standard_normal((e, f, d)) * 0.1}
    if cfg.shared_expert:
        w["shared"] = {"w_gate": rng.standard_normal((d, f)) * 0.1,
                       "w_up": rng.standard_normal((d, f)) * 0.1,
                       "w_down": rng.standard_normal((f, d)) * 0.1}
    return jax.tree_util.tree_map(lambda a: a.astype(np.float32), w)


def _inputs(rng, router, first, second):
    """x (1, T, d) whose router logits put ``first[t]`` ahead by ~3 and,
    for top-2, ``second[t]`` next."""
    cols = router / (router * router).sum(0)          # x . col_e = 1
    x = 3.0 * cols[:, first].T
    if second is not None:
        x = x + 1.5 * cols[:, second].T
    x = x + 0.02 * rng.standard_normal(x.shape)
    perm = rng.permutation(x.shape[0])
    return x[perm][None].astype(np.float32)


def _case(name, seed=0):
    k, shared, first, second = CASES[name]
    jcfg, tcfg = _cfgs(k, shared)
    rng = np.random.default_rng(seed)
    w = _weights(rng, tcfg)
    x = _inputs(rng, w["router"], first, second)
    return jcfg, tcfg, w, x


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _jax_routing(cfg, router, xf):
    """The reference's routing, by its own expressions (moe.py:60-77):
    (ids (T, k), sorted ids, rank, keep)."""
    logits = jnp.asarray(xf) @ jnp.asarray(router)
    gate, ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                              cfg.experts_per_token)
    flat = ids.reshape(-1)
    order = jnp.argsort(flat)
    sid = flat[order]
    rank = jnp.arange(flat.shape[0]) - jnp.searchsorted(sid, sid,
                                                        side="left")
    t, k, e = xf.shape[0], cfg.experts_per_token, cfg.num_experts
    cap = max(int(t * k / e * cfg.capacity_factor), 4)
    return tuple(np.asarray(a) for a in (ids, order, sid, rank, rank < cap))


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.mark.parametrize("name", sorted(CASES))
def test_routing_matches_jax_exactly(name):
    jcfg, tcfg, w, x = _case(name)
    xf = x[0]
    jids, jorder, jsid, jrank, jkeep = _jax_routing(jcfg, w["router"], xf)
    _, _, gate, ids = moe.route(tcfg, torch.from_numpy(w["router"]),
                                torch.from_numpy(xf))
    cap, order, sid, rank, keep, counts = moe.dispatch(tcfg, ids)
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_array_equal(order.numpy(), jorder)
    np.testing.assert_array_equal(sid.numpy(), jsid)
    np.testing.assert_array_equal(rank.numpy(), jrank)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    # the case is what its comment says: an overflow, not in expert E-1
    e = tcfg.num_experts
    assert (~keep).any() and int(counts[e - 1]) <= cap
    np.testing.assert_array_equal(
        counts.numpy(), np.bincount(jids.reshape(-1), minlength=e))


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_ffn_matches_jax(name):
    jcfg, tcfg, w, x = _case(name)
    jy, jaux = jmoe.moe_ffn(jcfg, jax.tree_util.tree_map(jnp.asarray, w),
                            jnp.asarray(x))
    ty, taux = moe.moe_ffn(tcfg, _torch(w), torch.from_numpy(x))
    assert ty.shape == x.shape and ty.dtype == torch.float32
    _close(ty.numpy(), jy)
    assert set(taux) == set(jaux) == {"moe_load_balance", "moe_z_loss",
                                      "moe_drop_frac"}
    for key in jaux:
        assert taux[key].dim() == 0 and taux[key].dtype == torch.float32
        _close(float(taux[key]), float(jaux[key]), msg=key)
    # the kept-only copy of the reference agrees wherever E-1 fits
    ky, _ = moe_ffn_kept(jcfg, jax.tree_util.tree_map(jnp.asarray, w),
                         jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(ky), np.asarray(jy))


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_ffn_gradients_match_jax(name):
    jcfg, tcfg, w, x = _case(name)

    def jloss(wx):
        wj, xj = wx
        y, _ = jmoe.moe_ffn(jcfg, wj, xj)
        return jnp.sum(y * jnp.cos(jnp.arange(y.size).reshape(y.shape)))

    jg = jax.grad(jloss)((jax.tree_util.tree_map(jnp.asarray, w),
                          jnp.asarray(x)))
    tw, tx = _torch(w), torch.from_numpy(x).requires_grad_()

    def track(tree):
        for v in tree.values():
            if isinstance(v, dict):
                track(v)
            else:
                v.requires_grad_()
    track(tw)
    ty, _ = moe.moe_ffn(tcfg, tw, tx)
    loss = (ty * torch.cos(torch.arange(ty.numel()).reshape(ty.shape))).sum()
    loss.backward()
    _close(tx.grad.numpy(), jg[1], rtol=1e-4, msg="x")

    def walk(t, j, path=""):
        for k in t:
            if isinstance(t[k], dict):
                walk(t[k], j[k], path + k + "/")
            else:
                _close(t[k].grad.numpy(), j[k], rtol=1e-4, msg=path + k)
    walk(tw, jg[0])
    assert float(tw["router"].grad.abs().max()) > 0     # gates are live


def test_last_expert_overflow_is_a_known_reference_fault():
    """8 tokens, 4 experts, top-1, every token routed to the last expert,
    cap 4: the port keeps the 4 first tokens (rank < 4) and drops 4,
    as moe_drop_frac (0.5) says; the reference zeroes the 4th kept token
    too (only 3 rows non-zero), its later zero writes landing on the
    real slot (E-1, C-1)."""
    jcfg, tcfg = _cfgs(1, False)
    rng = np.random.default_rng(5)
    w = _weights(rng, tcfg)
    x = _inputs(rng, w["router"], [3] * 8, None)
    jy, jaux = jmoe.moe_ffn(jcfg, jax.tree_util.tree_map(jnp.asarray, w),
                            jnp.asarray(x))
    ty, taux = moe.moe_ffn(tcfg, _torch(w), torch.from_numpy(x))
    jy, ty = np.asarray(jy)[0], ty.numpy()[0]
    live_t = np.flatnonzero(np.abs(ty).max(-1) > 0)
    live_j = np.flatnonzero(np.abs(jy).max(-1) > 0)
    np.testing.assert_array_equal(live_t, np.arange(4))     # rank < cap
    np.testing.assert_array_equal(live_j, np.arange(3))     # + the collision
    assert float(taux["moe_drop_frac"]) == float(jaux["moe_drop_frac"]) == 0.5
    _close(ty[:3], jy[:3])
    assert np.abs(ty[3]).max() > 1e-3 and np.abs(jy[3]).max() == 0.0
    # the kept-only reference is the port's
    ky, _ = moe_ffn_kept(jcfg, jax.tree_util.tree_map(jnp.asarray, w),
                         jnp.asarray(x))
    _close(ty, np.asarray(ky)[0])


def test_top_k_ties_go_to_the_lower_expert():
    """Equal router probabilities: ``jax.lax.top_k`` takes the lower ids
    first, and so does the port (a bare ``torch.topk`` promises no
    order)."""
    jcfg, tcfg = _cfgs(2, False)
    tcfg = dataclasses.replace(tcfg, num_experts=8)
    jcfg = dataclasses.replace(jcfg, num_experts=8)
    router = np.zeros((tcfg.d_model, 8), np.float32)
    router[0, [1, 3, 5, 6]] = 1.0                        # four-way tie
    xf = np.zeros((6, tcfg.d_model), np.float32)
    xf[:, 0] = 1.0
    jids = _jax_routing(jcfg, router, xf)[0]
    _, _, gate, ids = moe.route(tcfg, torch.from_numpy(router),
                                torch.from_numpy(xf))
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_array_equal(ids.numpy(), np.tile([1, 3], (6, 1)))
    _close(gate.numpy(), np.full((6, 2), 0.5))
