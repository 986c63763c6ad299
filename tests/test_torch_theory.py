"""The port's ``core/theory.py`` against the JAX package's: every function
gives the same value, bit for bit (both are the same float64 numpy
arithmetic), on seeded random distributions over 2-30 outcomes, on near
point masses and at the Fig. 2 closed forms; and the port's copy keeps
the Theorem 1 / 2 properties ``tests/test_theory.py`` holds the
reference to, on the same kind of draws."""
import numpy as np
import pytest

from repro.core import theory as jtheory
from repro_torch.core import theory

PAIR_FNS = ("kl", "chi2", "var_std", "var_new", "theorem1_terms",
            "bias_bound")


def _pairs(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(2, 31))
        p, q = rng.dirichlet(np.ones(k)), rng.dirichlet(np.ones(k))
        out.append((p, q))
    # near point masses: the high-KL regime where GEIW wins
    out.append((np.array([0.999, 1e-3]), np.array([1e-3, 0.999])))
    out.append((np.full(7, 1 / 7), np.full(7, 1 / 7)))
    return out


@pytest.mark.parametrize("fn", PAIR_FNS)
def test_pair_functions_equal_the_reference(fn):
    for p, q in _pairs(0):
        assert getattr(theory, fn)(p, q) == getattr(jtheory, fn)(p, q)


def test_bias_gepo_equals_the_reference():
    rng = np.random.default_rng(1)
    for p, q in _pairs(1):
        a = rng.normal(size=len(p))
        assert theory.bias_gepo(p, q, a) == jtheory.bias_gepo(p, q, a)


@pytest.mark.parametrize("a,b", [(0.9, 0.1), (0.5, 0.5), (0.2, 0.7),
                                 (0.01, 0.99)])
def test_bernoulli_vars_equal_the_reference(a, b):
    assert theory.bernoulli_vars(a, b) == jtheory.bernoulli_vars(a, b)


@pytest.mark.parametrize("delta_mu", [0.5, 1.0, 2.0, 3.0])
def test_gaussian_vars_equal_the_reference(delta_mu):
    assert theory.gaussian_vars(0.0, delta_mu) == \
        jtheory.gaussian_vars(0.0, delta_mu)
    assert theory.gaussian_vars(1.0, delta_mu, num=2001, span=8.0) == \
        jtheory.gaussian_vars(1.0, delta_mu, num=2001, span=8.0)


def test_theorem1_and_theorem2_hold_on_the_port():
    """Delta >= exp(KL) - (n^2 + 1), Delta > 0 once exp(KL) > n^2 + 1,
    the GEPO bias under ||p|| / ||q||, and KL <= log(1 + chi^2)."""
    rng = np.random.default_rng(2)
    wins = 0
    for p, q in _pairs(2, n=200):
        delta, exp_kl, c = theory.theorem1_terms(p, q)
        assert delta >= exp_kl - c - 1e-6
        if exp_kl > c:
            assert delta > 0
            wins += 1
        a = rng.normal(size=len(p))
        assert theory.bias_gepo(p, q, a) <= theory.bias_bound(p, q) + 1e-9
        assert theory.kl(p, q) <= np.log1p(theory.chi2(p, q)) + 1e-9
    assert wins >= 1                     # the point-mass pair


def test_fig2_claims_hold_on_the_port():
    v_std, v_new = theory.bernoulli_vars(0.9, 0.1)
    assert v_new < v_std
    v_std, v_new = theory.bernoulli_vars(0.5, 0.5)
    assert v_std == pytest.approx(0.0, abs=1e-12) and v_new >= 0.0
    gaps = [np.subtract(*theory.gaussian_vars(0.0, m)[:2])
            for m in (1.0, 2.0, 3.0)]
    assert gaps[0] < gaps[1] < gaps[2] and gaps[2] > 0


def test_var_formulas_against_monte_carlo():
    """The closed forms against sampled importance weights (400k draws
    from a well-conditioned q, as the reference's property test)."""
    rng = np.random.default_rng(3)
    for _ in range(5):
        k = int(rng.integers(2, 9))
        p = rng.dirichlet(np.ones(k)) * 0.5 + 0.5 / k
        q = rng.dirichlet(np.ones(k)) * 0.5 + 0.5 / k
        idx = rng.choice(k, size=400_000, p=q)
        assert np.isclose((p[idx] / q[idx]).var(), theory.var_std(p, q),
                          rtol=0.25, atol=0.05)
        assert np.isclose((p[idx] / np.sum(q * q)).var(),
                          theory.var_new(p, q), rtol=0.25, atol=0.05)
