"""The port's threefry PRNG (``repro_torch.sampling.prng``) against
``jax.random`` (jax 0.9, ``jax_threefry_partitionable`` on, x64 off, the
suite's settings), and the port's ``sample_token_rows`` against the
reference's.

Tolerances: keys, split keys, random bits and uniforms bit for bit (integer
work and one exact float subtraction). Gumbel noise: within NOISE_ULPS (4)
ulps of max(|g|, 1): each of its two float32 logs is within 1 ulp of
exact in either framework, so the two may sit 2 ulps apart, which moves g
by 2 ulps of 1 through the inner log and 2 ulps of |g| through the outer
one (measured: 1). Tokens of categorical draws and of ``sample_token_rows``
exactly (a flip would need two scores within ~1e-6 of each other).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sampling.sample import sample_token_rows as jsample_token_rows
from repro_torch.sampling import prng
from repro_torch.sampling.sample import sample_token_rows

NOISE_ULPS = 4
SEEDS = [0, 1, 3, 42, 2 ** 31 - 1, 2 ** 31 + 5, 2 ** 32 - 1, 2 ** 32 + 7,
         -1, -12345]


def _np(key):
    return np.asarray(key).astype(np.int64)


def _keys(n, seed=0):
    """``n`` distinct jax keys (split of a fold), as (jax, port) pairs."""
    jk = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), 11),
                          n)
    return jk, prng.as_key(_np(jk))


def _ulps(got, want):
    mag = np.maximum(np.abs(want), 1.0).astype(np.float32)
    return np.abs(got - want) / (np.nextafter(mag, np.float32(np.inf)) - mag)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                  _np(jax.random.PRNGKey(seed)))


def test_fold_in_batched_and_scalar():
    jk, tk = _keys(64, seed=1)
    data = np.array([0, 1, 2, 7, 2 ** 31 - 1, -1, -2 ** 31, 123456789] * 8,
                    np.int32)
    want = jax.vmap(jax.random.fold_in)(jk, jnp.asarray(data))
    got = prng.fold_in(tk, torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    for d in (0, 5, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(prng.PRNGKey(9), d).numpy(),
            _np(jax.random.fold_in(jax.random.PRNGKey(9), d)))
    # one key, many data: broadcasts like vmap over the data alone
    got = prng.fold_in(prng.PRNGKey(4), torch.arange(10))
    want = jax.vmap(lambda d: jax.random.fold_in(jax.random.PRNGKey(4), d))(
        jnp.arange(10))
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("num", [1, 2, 3, 7, 64])
def test_split(num):
    for seed in SEEDS[:5]:
        np.testing.assert_array_equal(
            prng.split(prng.PRNGKey(seed), num).numpy(),
            _np(jax.random.split(jax.random.PRNGKey(seed), num)))
    jk, tk = _keys(5, seed=num)
    np.testing.assert_array_equal(
        prng.split(tk, num).numpy(),
        _np(jax.vmap(lambda k: jax.random.split(k, num))(jk)))
    # the sampler node's per-batch step: key, k = split(key)
    key = prng.PRNGKey(3)
    jkey = jax.random.PRNGKey(3)
    for _ in range(4):
        key, k = prng.split(key)
        jkey, jsub = jax.random.split(jkey)
        np.testing.assert_array_equal(k.numpy(), _np(jsub))
    np.testing.assert_array_equal(key.numpy(), _np(jkey))


@pytest.mark.parametrize("shape", [(), (1,), (5,), (3, 7), (2, 3, 4),
                                   (152064,)])
def test_random_bits(shape):
    for seed in (0, 3, 2 ** 31 + 5):
        want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape))
        got = prng.random_bits(prng.PRNGKey(seed), shape).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


def test_random_bits_batched_keys():
    jk, tk = _keys(16, seed=2)
    want = jax.vmap(lambda k: jax.random.bits(k, (33,)))(jk)
    np.testing.assert_array_equal(prng.random_bits(tk, (33,)).numpy(),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (float(np.finfo(
    np.float32).tiny), 1.0)])
def test_uniform_bit_for_bit(lo, hi):
    jk, tk = _keys(12, seed=5)
    want = jax.vmap(lambda k: jax.random.uniform(
        k, (4099,), minval=lo, maxval=hi))(jk)
    got = prng.uniform(tk, (4099,), minval=lo, maxval=hi)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    assert float(got.min()) >= lo and float(got.max()) < hi


def test_uniform_other_range():
    """A range wider than 1 scales the unit draw: within one ulp of the
    value (a fused multiply-add may round once where torch rounds
    twice)."""
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(6), (2000,),
                                         minval=-2.0, maxval=3.0))
    got = prng.uniform(prng.PRNGKey(6), (2000,), minval=-2.0,
                       maxval=3.0).numpy()
    assert _ulps(got, want).max() <= 1


@pytest.mark.parametrize("v", [7, 1000, 152064])
def test_gumbel_within_ulps(v):
    jk, tk = _keys(4 if v == 152064 else 32, seed=v)
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (v,)))(jk))
    got = prng.gumbel(tk, (v,)).numpy()
    assert np.isfinite(got).all()
    assert _ulps(got, want).max() <= NOISE_ULPS


@pytest.mark.parametrize("v", [5, 300, 152064])
def test_categorical_tokens(v):
    rows = 1 if v == 152064 else 64
    jk, tk = _keys(rows, seed=v + 1)
    logits = (np.random.default_rng(v).standard_normal((rows, v)) * 3
              ).astype(np.float32)
    want = jax.vmap(jax.random.categorical)(jk, jnp.asarray(logits))
    got = prng.categorical(tk, torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(TypeError, match="float32"):
        prng.categorical(tk, torch.from_numpy(logits).double())


@pytest.mark.parametrize("kw", [
    dict(temperature=1.0, top_k=0, top_p=1.0),
    dict(temperature=0.6, top_k=20, top_p=0.95),
    dict(temperature=0.8, top_k=8, top_p=0.9),
    dict(temperature=1.0, top_k=1, top_p=1.0),
    dict(temperature=1.3, top_k=0, top_p=0.5)])
def test_sample_token_rows_matches_jax(kw):
    """The engines' draw: the reference's ``vmap(sample_token)`` over
    per-row keys, token for token, including one row at qwen3's padded
    vocab."""
    for rows, v in ((48, 64), (1, 152064)):
        jk, tk = _keys(rows, seed=rows + v)
        logits = (np.random.default_rng(rows).standard_normal((rows, v))
                  * 2).astype(np.float32)
        want, _, _ = jsample_token_rows(jk, jnp.asarray(logits), **kw)
        got = sample_token_rows(tk, torch.from_numpy(logits), **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_draws_copy_no_host_data_to_the_device(monkeypatch):
    """A draw builds no tensor from host data: on the card each such
    tensor is a copy from pageable memory that waits for the card (the
    bounds of ``uniform`` cost two of them per decode step)."""
    keys = prng.fold_in(prng.PRNGKey(3), torch.arange(4))

    def refuse(*args, **kwargs):
        raise AssertionError("a tensor built from host data in a draw")

    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    logits = torch.zeros((4, 64))
    prng.categorical(keys, logits)
    sample_token_rows(keys, logits, temperature=0.6, top_k=20, top_p=0.95)


def test_keys_from_jax_arrays_and_errors():
    jk = jax.random.PRNGKey(8)
    np.testing.assert_array_equal(prng.as_key(np.asarray(jk)).numpy(),
                                  _np(jk))
    np.testing.assert_array_equal(prng.as_key([0, 8]).numpy(), _np(jk))
    with pytest.raises(ValueError, match="2 words"):
        prng.as_key([1, 2, 3])
