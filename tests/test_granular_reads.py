"""generators/granular.py: the grain read (Catmull-Rom gather with the
file-circle tap wrap, granular.rs:899-933) and the window LUT lerp
(granular.rs:201-215) against float64 NumPy oracles, for plain ramps,
global wraps, reverse reads, loop folds, mid-chunk triggers and all 8
window shapes."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from phonic_tpu.generators import granular as gr


def _oracle_cr(mono, fidx):
    mono = np.asarray(mono, np.float64)
    frames = mono.shape[0]
    fidx = np.asarray(fidx, np.float64)
    i1 = np.minimum(fidx.astype(np.int64), frames - 1)
    frac = fidx - i1
    i0 = np.where(i1 > 0, i1 - 1, frames - 1)
    i2 = np.where(i1 < frames - 1, i1 + 1, 0)
    i3 = np.where(i2 < frames - 1, i2 + 1, 0)
    y0, y1, y2, y3 = mono[i0], mono[i1], mono[i2], mono[i3]
    a = -0.5 * y0 + 1.5 * y1 - 1.5 * y2 + 0.5 * y3
    b = y0 - 2.5 * y1 + 2.0 * y2 - 0.5 * y3
    c = -0.5 * y0 + 0.5 * y2
    return ((a * frac + b) * frac + c) * frac + y1


def _run_case(frames, n, pos0, inc, loop, ls=0.2, le=0.7, first=None):
    """Grain positions as granular_voice_alloc builds them (normalized
    ramp, folded into the loop range or wrapped on the file circle)."""
    rng = np.random.default_rng(1)
    mono = rng.uniform(-1, 1, frames).astype(np.float32)
    j = np.arange(n, dtype=np.float32)
    pos_u = (np.asarray(pos0, np.float32)[:, None]
             + j[None, :] * np.asarray(inc, np.float32)[:, None])
    if first is not None:  # the slot held a stale grain before the trigger
        stale = np.float32(0.9)
        pos_u = np.where(j[None, :] >= np.asarray(first)[:, None], pos_u,
                         stale)
    ll = np.float32(max(le - ls, 1e-9))
    folded = ls + np.mod(pos_u - ls, ll)
    pos = np.where(np.asarray(loop, bool)[:, None], folded,
                   np.mod(pos_u, 1.0))
    fidx = (pos * np.float32(frames - 1)).astype(np.float32)
    got = np.asarray(gr.catmull_rom_gather(jnp.asarray(mono),
                                           jnp.asarray(fidx)))
    err = np.abs(got - _oracle_cr(mono, fidx)).max()
    assert err < 1e-5, err


def test_plain_ramps_match_oracle():
    _run_case(9000, 512, pos0=[0.1, 0.45, 0.8],
              inc=[0.9 / 9000, 2.0 / 9000, 0.3 / 9000],
              loop=[False, False, False])


def test_global_wrap_matches_oracle():
    # positions run off the end of the file and wrap to the head mid-chunk
    _run_case(4000, 512, pos0=[0.95, 0.999], inc=[2.0 / 4000, 3.5 / 4000],
              loop=[False, False])


def test_reverse_and_left_wrap():
    _run_case(4000, 512, pos0=[0.05, 0.3], inc=[-2.0 / 4000, -0.5 / 4000],
              loop=[False, False])


def test_loop_fold_short_and_long():
    # short loop (many folds per chunk) and long loop (one fold)
    _run_case(16000, 512, pos0=[0.21, 0.3], inc=[3.0 / 16000, 2.0 / 16000],
              loop=[True, True], ls=0.2, le=0.215)
    _run_case(16000, 512, pos0=[0.68, 0.25], inc=[2.0 / 16000, -2.0 / 16000],
              loop=[True, True], ls=0.2, le=0.7)


def test_mid_chunk_trigger():
    # the grain becomes live at sample 300; earlier samples read the stale
    # slot's position (the render masks them with the grain weight)
    _run_case(6000, 512, pos0=[0.5], inc=[1.5 / 6000], loop=[False],
              first=[300])


def _window_table64():
    """The 8 windows of granular.rs:112-196 in float64."""
    n = gr.WINDOW_N
    u = np.arange(n) / n
    c2 = np.cos(2 * np.pi * u)
    tri = np.where(u < 0.5, 2 * u, 2 * (1 - u))
    tk = 0.25
    tukey = np.where(u < tk, 0.5 * (1 - np.cos(np.pi * u / tk)),
                     np.where(u > 1 - tk,
                              0.5 * (1 - np.cos(np.pi * (1 - u) / tk)), 1.0))
    trap = np.where(u < 0.1, u / 0.1, np.where(u > 0.9, (1 - u) / 0.1, 1.0))
    ramp_up = np.where(u < 0.9, u / 0.9,
                       0.5 * (1 + np.cos(np.pi * (u - 0.9) / 0.1)))
    ramp_down = np.where(u < 0.1, 0.5 * (1 - np.cos(np.pi * u / 0.1)),
                         1.0 - (u - 0.1) / 0.9)
    return np.stack([0.5 * (1 - c2),
                     0.42 - 0.5 * c2 + 0.08 * np.cos(4 * np.pi * u),
                     tri, tukey, trap, np.exp(-6.0 * np.abs(u - 0.5)),
                     ramp_up, ramp_down])


@pytest.mark.parametrize("mode", range(8))
def test_window_sample_matches_oracle(mode):
    rng = np.random.default_rng(mode)
    phase = rng.uniform(-0.1, 1.1, (3, 700)).astype(np.float32)
    wmode = np.full(phase.shape, mode, np.int32)
    got = np.asarray(gr.window_sample(jnp.asarray(wmode), jnp.asarray(phase)))
    idx_f = np.clip(phase.astype(np.float64), 0, 1) * (gr.WINDOW_N - 1)
    idx = np.minimum(idx_f.astype(np.int64), gr.WINDOW_N - 2)
    frac = idx_f - idx
    lut = _window_table64()[mode]
    want = lut[idx] * (1 - frac) + lut[idx + 1] * frac
    np.testing.assert_allclose(got, want, atol=2e-6)


def _unfused_split_product(a, b):
    """granular._split_product in NumPy float32, each product rounded on
    its own (no fused multiply-add)."""
    def hi12(x):
        return (np.ascontiguousarray(x, np.float32).view(np.int32)
                & np.int32(-4096)).view(np.float32)
    a, b = np.broadcast_arrays(np.float32(a), np.float32(b))
    a_hi, b_hi = hi12(a), hi12(b)
    a_lo, b_lo = a - a_hi, b - b_hi
    return (a_hi * b_hi + a_hi * b_lo) + (a_lo * b_hi + a_lo * b_lo)


@pytest.mark.parametrize("what", ["read_offset", "pitch_ratio"])
def test_grain_arithmetic_rounds_as_unfused(what):
    # a grain's read offset and pitch, compiled, give the same bits whether
    # or not the platform fuses products into sums, and stay within float32 rounding of
    # the float64 values
    rng = np.random.default_rng(3)
    if what == "read_offset":
        local = rng.integers(0, 144000, 50000).astype(np.float32)
        inc = (rng.uniform(-4, 4, 50000) / 96000).astype(np.float32)
        got = np.asarray(jax.jit(gr._split_product)(local, inc))
        want = _unfused_split_product(local, inc)
        exact = local.astype(np.float64) * inc
        ulps = 2
    else:
        sem = rng.uniform(-1, 1, 50000).astype(np.float32)
        got = np.asarray(jax.jit(gr._pitch_ratio)(sem))
        want = np.full_like(sem, gr._PITCH_COEFFS[0])
        for c in gr._PITCH_COEFFS[1:]:
            want = _unfused_split_product(want, sem) + np.float32(c)
        exact = np.exp2(sem.astype(np.float64) / 12.0)
        ulps = 1
    np.testing.assert_array_equal(got, want)
    err = np.abs(got - exact) / np.spacing(np.abs(exact).astype(np.float32))
    assert err.max() <= ulps
