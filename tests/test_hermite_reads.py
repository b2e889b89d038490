"""ops/resample.py: the Hermite gather read and the one-hot mm2 read against
a float64 NumPy oracle, for every position-stream shape the file sources
and sampler voices produce: ramps, loop and ping-pong folds, reverse
reads, out-of-range positions, ragged lengths, several stereo sources and
vmapped lanes (reference: src/utils/resampler/cubic.rs:121-142,
src/source/file/preloaded.rs:270-332)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phonic_tpu.ops.resample import hermite_read, hermite_read_mm2, mm_pack

TOL = 1e-5


def _oracle(src, pos):
    """4-point Hermite x-form in float64; missing taps read zero.
    src [ch, F], pos [n] -> [ch, n]."""
    src = np.asarray(src, np.float64)
    frames = src.shape[-1]
    pos = np.asarray(pos, np.float64)
    k = np.floor(pos).astype(np.int64)
    f = pos - k

    def tap(o):
        i = k + o
        ok = (i >= 0) & (i < frames)
        return np.where(ok, src[:, np.clip(i, 0, frames - 1)], 0.0)

    ym1, y0, y1, y2 = tap(-1), tap(0), tap(1), tap(2)
    c1 = (y1 - ym1) * 0.5
    c2 = ym1 - y0 * 2.5 + y1 * 2.0 - y2 * 0.5
    c3 = (y2 - ym1) * 0.5 + (y0 - y1) * 1.5
    return ((c3 * f + c2) * f + c1) * f + y0


def _check(src, pos, smax):
    """Both reads of one [ch, F] source against the oracle."""
    want = _oracle(src, pos)
    got = np.asarray(hermite_read(jnp.asarray(src), jnp.asarray(pos)))
    assert np.abs(got - want).max() <= TOL
    got = np.asarray(hermite_read_mm2(jnp.asarray(mm_pack(src)),
                                      jnp.asarray(pos), smax=smax))
    assert np.abs(got - want).max() <= TOL


def _fold(p, kind, ls, le):
    if kind == "loop":
        return np.where(p < ls, p, ls + np.mod(p - ls, le - ls))
    c = np.mod(p - ls, 2 * (le - ls))
    return np.where(p < ls, p, ls + np.where(c < le - ls, c, 2 * (le - ls) - c))


def test_matches_oracle_basic():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(2, 9000)).astype(np.float32)
    pos = (np.cumsum(rng.uniform(0.2, 2.0, 4096)) + 57.3).astype(np.float32)
    _check(src, pos, smax=2.0)


def test_out_of_range_positions_read_zero():
    rng = np.random.default_rng(1)
    src = rng.normal(size=(1, 2000)).astype(np.float32)
    pos = np.linspace(-40.0, 2040.0, 1500, dtype=np.float32)
    _check(src, pos, smax=2.0)
    out = np.asarray(hermite_read(jnp.asarray(src), jnp.asarray(pos)))
    assert np.all(out[0, pos < -3.0] == 0.0)
    assert np.all(out[0, pos > 2002.0] == 0.0)


@pytest.mark.parametrize("kind", ["forward", "loop_short", "loop_long",
                                  "pingpong", "reverse"])
def test_folds_and_direction(kind):
    rng = np.random.default_rng(len(kind))
    src = rng.normal(size=(1, 3000)).astype(np.float32)
    steps = rng.uniform(0.1, 4.0, 5000)
    if kind == "reverse":
        p = 2900.0 - np.cumsum(steps) * 0.2
    else:
        p = np.cumsum(steps) + 10.0
    if kind == "loop_short":  # shorter than one chunk's travel
        p = _fold(p, "loop", 500.0, 800.0)
    elif kind == "loop_long":
        p = _fold(p, "loop", 100.0, 2900.0)
    elif kind == "pingpong":
        p = _fold(p, "pingpong", 200.0, 1400.0)
    _check(src, p.astype(np.float32), smax=4.0)


def test_ragged_length_and_small_n():
    rng = np.random.default_rng(2)
    src = rng.normal(size=(1, 700)).astype(np.float32)
    for n in (1, 37, 100, 129, 1000, 2049):
        p = _fold(np.cumsum(rng.uniform(0.1, 4.0, n)) + 300.0, "loop",
                  100.0, 620.0)
        _check(src, p.astype(np.float32), smax=4.0)


def test_fuzz_folds():
    rng = np.random.default_rng(3)
    src = rng.normal(size=(1, 700)).astype(np.float32)
    for trial in range(12):
        n = int(rng.integers(40, 3000))
        kind = trial % 3
        steps = rng.uniform(-4, 4, n) if kind else rng.uniform(0.1, 4, n)
        p = np.cumsum(steps) + rng.uniform(-5, 700)
        ls = rng.uniform(0, 300)
        if kind == 1:
            p = _fold(p, "loop", ls, ls + rng.uniform(30, 5000))
        elif kind == 2:
            p = _fold(p, "pingpong", ls, ls + rng.uniform(30, 2000))
        _check(src, p.astype(np.float32), smax=4.0)


def test_multi_source_batch_and_stereo():
    # the FileBatch shape: a bank of stereo sources, one position stream
    # each, read under vmap
    rng = np.random.default_rng(4)
    src = rng.normal(size=(4, 2, 5000)).astype(np.float32)
    pos = (np.cumsum(rng.uniform(0.3, 1.0, (4, 3000)), -1)
           + rng.uniform(0, 1000, (4, 1))).astype(np.float32)
    want = np.stack([_oracle(src[i], pos[i]) for i in range(4)])
    got = np.asarray(jax.vmap(hermite_read)(jnp.asarray(src),
                                            jnp.asarray(pos)))
    assert got.shape == (4, 2, 3000)
    assert np.abs(got - want).max() <= TOL
    got = np.asarray(jax.vmap(lambda b, p: hermite_read_mm2(b, p, smax=1.0))(
        jnp.asarray(mm_pack(src)), jnp.asarray(pos)))
    assert np.abs(got - want).max() <= TOL


def test_vmap_lanes_and_nesting():
    # BatchedRenderProgram vmaps whole graphs: reads nest inside lane vmaps
    rng = np.random.default_rng(9)
    src = rng.normal(size=(1, 3000)).astype(np.float32)
    pos = (np.cumsum(rng.uniform(0.2, 2.0, (3, 4, 1000)), -1)
           + rng.uniform(0, 50, (3, 4, 1))).astype(np.float32)
    want = np.stack([[_oracle(src, p) for p in lane] for lane in pos])
    read = lambda p: hermite_read(jnp.asarray(src), p)
    got = np.asarray(jax.vmap(jax.vmap(read))(jnp.asarray(pos)))
    assert np.abs(got - want).max() <= TOL
    packed = jnp.asarray(mm_pack(src))
    read2 = lambda p: hermite_read_mm2(packed, p, smax=2.0)
    got = np.asarray(jax.vmap(jax.vmap(read2))(jnp.asarray(pos)))
    assert np.abs(got - want).max() <= TOL
