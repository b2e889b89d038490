"""ops/scan.py: both evaluation routes of the linear recurrences (the
associative scan below _CHUNKED_MIN_T, the two-level chunked scan above
it) against a float64 NumPy oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phonic_tpu.ops import scan
from phonic_tpu.ops.scan import linear_recurrence, linear_recurrence_2

TOL = 1e-4
ROUTES = {"associative": 700, "chunked": scan._CHUNKED_MIN_T + 904}


def _mk1(r, t, seed=7):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.8, 0.999, (r, t)).astype(np.float32)
    b = rng.normal(size=(r, t)).astype(np.float32)
    y0 = rng.normal(size=(r,)).astype(np.float32)
    return a, b, y0


def _mk2(r, t, seed=8):
    rng = np.random.default_rng(seed)
    diag = lambda: rng.uniform(0.7, 0.95, (r, t)).astype(np.float32)
    off = lambda: rng.uniform(-0.2, 0.2, (r, t)).astype(np.float32)
    a11, a12, a21, a22 = diag(), off(), off(), diag()
    b1, b2 = (rng.normal(size=(r, t)).astype(np.float32) for _ in range(2))
    s01, s02 = (rng.normal(size=(r,)).astype(np.float32) for _ in range(2))
    return a11, a12, a21, a22, b1, b2, s01, s02


def _oracle1(a, b, y0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    y = np.empty_like(b)
    prev = np.asarray(y0, np.float64)
    for n in range(b.shape[-1]):
        prev = a[..., n] * prev + b[..., n]
        y[..., n] = prev
    return y


def _oracle2(a11, a12, a21, a22, b1, b2, s01, s02):
    c = [np.asarray(v, np.float64) for v in (a11, a12, a21, a22, b1, b2)]
    s1, s2 = np.asarray(s01, np.float64), np.asarray(s02, np.float64)
    o1, o2 = np.empty_like(c[4]), np.empty_like(c[5])
    for n in range(c[4].shape[-1]):
        s1, s2 = (c[0][..., n] * s1 + c[1][..., n] * s2 + c[4][..., n],
                  c[2][..., n] * s1 + c[3][..., n] * s2 + c[5][..., n])
        o1[..., n], o2[..., n] = s1, s2
    return o1, o2


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_iir1_matches_oracle(route):
    a, b, y0 = _mk1(5, ROUTES[route])
    got = np.asarray(linear_recurrence(a, b, y0))
    assert np.abs(got - _oracle1(a, b, y0)).max() < TOL


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_iir2_matches_oracle(route):
    args = _mk2(3, ROUTES[route])
    g1, g2 = linear_recurrence_2(*args)
    w1, w2 = _oracle2(*args)
    assert np.abs(np.asarray(g1) - w1).max() < TOL
    assert np.abs(np.asarray(g2) - w2).max() < TOL


def test_iir1_multichunk_state_carry():
    # 16 chunks of 32: the boundary state must thread through every chunk,
    # including a ragged last chunk (padded with a = 1, b = 0)
    a, b, y0 = _mk1(2, 16 * 32 - 5)
    got = np.asarray(scan._chunked_first(jnp.asarray(a), jnp.asarray(b),
                                         jnp.asarray(y0)))
    assert np.abs(got - _oracle1(a, b, y0)).max() < TOL


def test_iir2_multichunk_state_carry():
    args = _mk2(2, 12 * 16 + 3)
    g1, g2 = scan._chunked_second(*map(jnp.asarray, args))
    w1, w2 = _oracle2(*args)
    assert np.abs(np.asarray(g1) - w1).max() < TOL
    assert np.abs(np.asarray(g2) - w2).max() < TOL


def test_iir1_under_vmap():
    a, b, y0 = _mk1(6, ROUTES["chunked"])
    a, b = a.reshape(2, 3, -1), b.reshape(2, 3, -1)
    y0 = y0.reshape(2, 3)
    got = np.asarray(jax.vmap(linear_recurrence)(a, b, y0))
    assert np.abs(got - _oracle1(a, b, y0)).max() < TOL


@pytest.mark.parametrize("t", [1, 2, 130])
def test_iir1_odd_lengths(t):
    a, b, y0 = _mk1(3, t)
    got = np.asarray(linear_recurrence(a, b, y0))
    assert np.abs(got - _oracle1(a, b, y0)).max() < TOL
