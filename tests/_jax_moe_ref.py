"""The JAX package's ``moe_ffn`` with its dispatch scatter writing only
the kept entries: the reference for the port's parity tests.

``repro/models/moe.py`` scatters every dropped entry as a zero row onto
the real slot (E-1, C-1), so whenever expert E-1 overflows, XLA's CPU
scatter lets a later zero write win and that expert's last kept token is
zeroed too (ROADMAP queue 3). This copy differs from the reference in the
scatter's indices alone: a dropped entry goes to the out-of-range row
(E, C), which ``mode="drop"`` discards. ``tests/test_torch_moe.py`` holds
the port against the reference itself wherever expert E-1 stays under its
capacity, and pins the difference where it overflows; the model-level
tests run the JAX package through this copy (``patch_jax_moe``), because
random routers overflow expert E-1 in most forwards.
"""
import jax
import jax.numpy as jnp

import repro.models.model as jmodel
from repro.models.layers import swiglu


def moe_ffn_kept(cfg, p, x):
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    xf = x.reshape(t, d)
    logits = (xf.astype(jnp.float32) @ p["router"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    gate, ids = jax.lax.top_k(probs, k)
    if k > 1:
        gate = gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)
    cap = max(int(t * k / e * cfg.capacity_factor), 4)
    flat_ids = ids.reshape(-1)
    order = jnp.argsort(flat_ids)
    sorted_ids = flat_ids[order]
    rank = jnp.arange(t * k) - jnp.searchsorted(sorted_ids, sorted_ids,
                                                side="left")
    tok_of = order // k
    keep = rank < cap
    buf = jnp.zeros((e, cap, d), x.dtype)
    buf = buf.at[
        jnp.where(keep, sorted_ids, e),          # the reference: e - 1
        jnp.where(keep, rank, cap),              # the reference: cap - 1
    ].set(xf[tok_of], mode="drop")
    h = jax.nn.silu(jnp.einsum("ecd,edf->ecf", buf, p["w_gate"]))
    h = h * jnp.einsum("ecd,edf->ecf", buf, p["w_up"])
    out_buf = jnp.einsum("ecf,efd->ecd", h, p["w_down"])
    y_sorted = out_buf[sorted_ids, rank] * keep[:, None]
    y_flat = jnp.zeros((t * k, d), x.dtype).at[order].set(y_sorted)
    y = (y_flat.reshape(t, k, d)
         * gate[..., None].astype(x.dtype)).sum(axis=1)
    if cfg.shared_expert:
        y = y + swiglu(xf, p["shared"])
    me = probs.mean(axis=0)
    ce = jnp.zeros((e,)).at[flat_ids].add(1.0) / (t * k)
    aux = {
        "moe_load_balance": e * jnp.sum(me * ce),
        "moe_z_loss": jnp.mean(jax.nn.logsumexp(logits, axis=-1) ** 2),
        "moe_drop_frac": 1.0 - keep.mean(),
    }
    return y.reshape(b, s, d), aux


def patch_jax_moe(monkeypatch):
    """Route the JAX model's MoE layers through ``moe_ffn_kept`` (read at
    trace time; the test modules' executables are dropped between modules
    by ``conftest.py``)."""
    monkeypatch.setattr(jmodel, "moe_ffn", moe_ffn_kept)
