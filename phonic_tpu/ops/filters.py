"""Second-order TPT (topology-preserving transform) filters + DC blocker.

Behavioural spec:
  - biquad (9 types, Cytomic SVF topology): reference
    src/utils/dsp/filters/biquad.rs:160-290 (coefficients), :320-340 (core)
  - SVF (LP/HP/BP with resonance): reference src/utils/dsp/filters/svf.rs
  - DC blocker one-pole: reference src/utils/dsp/filters/dc.rs

Both filter families share the same trapezoidal-integrator core

    v3 = x - ic2 ; v1 = a1*ic1 + a2*v3 ; v2 = ic2 + a2*ic1 + a3*v3
    ic1' = 2*v1 - ic1 ; ic2' = 2*v2 - ic2 ; y = m0*x + m1*v1 + m2*v2

which is linear in the state (ic1, ic2):

    A = [[2*a1-1, -2*a2], [2*a2, 1-2*a3]],  b = (2*a2*x, 2*a3*x)

so a whole block is evaluated with one parallel associative scan
(ops/scan.linear_recurrence_2), including *per-sample time-varying
coefficients* — the answer to the reference recomputing coefficients
every frame while a cutoff ramp is active (src/effect/filter.rs:160-196).
v1/v2 are recovered from consecutive states: v = (s[n] + s[n-1]) / 2.

The reference keeps filter state in f64; we default to f32 scans (validated
< -90 dB error vs a float64 oracle in tests/test_filters.py) with
``dtype=jnp.float64`` available for strict-parity runs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp

from .scan import linear_recurrence, linear_recurrence_2

LOWPASS = "lowpass"
HIGHPASS = "highpass"
BANDPASS = "bandpass"
NOTCH = "notch"
PEAK = "peak"
ALLPASS = "allpass"
BELL = "bell"
LOWSHELF = "lowshelf"
HIGHSHELF = "highshelf"

BIQUAD_TYPES = (
    LOWPASS, HIGHPASS, BANDPASS, NOTCH, PEAK, ALLPASS, BELL, LOWSHELF, HIGHSHELF,
)
SVF_TYPES = (LOWPASS, HIGHPASS, BANDPASS)


class TptCoefficients(NamedTuple):
    """a1..a3 integrator gains + m0..m2 output mix (all broadcastable, may be
    per-sample arrays for ramped parameters)."""

    a1: jnp.ndarray
    a2: jnp.ndarray
    a3: jnp.ndarray
    m0: jnp.ndarray
    m1: jnp.ndarray
    m2: jnp.ndarray


class TptState(NamedTuple):
    ic1: jnp.ndarray
    ic2: jnp.ndarray


def tpt_state_init(shape=(), dtype=jnp.float32) -> TptState:
    return TptState(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))


def biquad_coefficients(
    filter_type: str, sample_rate, cutoff, q, gain_db=0.0
) -> TptCoefficients:
    """Coefficients for the 9 biquad filter types
    (reference: src/utils/dsp/filters/biquad.rs:160-290).

    All inputs may be arrays (e.g. per-sample ramped cutoff)."""
    cutoff = jnp.asarray(cutoff, jnp.float32)
    q = jnp.asarray(q, jnp.float32)
    gain_db = jnp.asarray(gain_db, jnp.float32)
    g = jnp.tan(math.pi * cutoff / float(sample_rate))
    one = jnp.ones_like(g)

    if filter_type in (BELL, LOWSHELF, HIGHSHELF):
        a = jnp.power(10.0, gain_db / 40.0)
    if filter_type == BELL:
        k = 1.0 / (q * a)
    else:
        k = 1.0 / q
    if filter_type == LOWSHELF:
        g = g / jnp.sqrt(a)
    elif filter_type == HIGHSHELF:
        g = g * jnp.sqrt(a)

    a1 = 1.0 / (1.0 + g * (g + k))
    a2 = g * a1
    a3 = g * a2

    if filter_type == LOWPASS:
        m0, m1, m2 = 0.0 * one, 0.0 * one, one
    elif filter_type == HIGHPASS:
        m0, m1, m2 = one, -k, -one
    elif filter_type == BANDPASS:
        m0, m1, m2 = 0.0 * one, one, 0.0 * one
    elif filter_type == NOTCH:
        m0, m1, m2 = one, -k, 0.0 * one
    elif filter_type == PEAK:
        m0, m1, m2 = one, -k, -2.0 * one
    elif filter_type == ALLPASS:
        m0, m1, m2 = one, -2.0 * k, 0.0 * one
    elif filter_type == BELL:
        m0, m1, m2 = one, k * (a * a - 1.0), 0.0 * one
    elif filter_type == LOWSHELF:
        m0, m1, m2 = one, k * (a - 1.0), a * a - 1.0
    elif filter_type == HIGHSHELF:
        m0, m1, m2 = a * a, k * (1.0 - a) * a, 1.0 - a * a
    else:
        raise ValueError(f"unknown biquad type {filter_type!r}")
    return TptCoefficients(a1, a2, a3, m0, m1, m2)


def svf_coefficients(filter_type: str, sample_rate, cutoff, resonance) -> TptCoefficients:
    """SVF with 0..1 resonance mapped to damping k = max(2*(1-0.97*res), 0.03)
    (reference: src/utils/dsp/filters/svf.rs:170-186)."""
    cutoff = jnp.asarray(cutoff, jnp.float32)
    resonance = jnp.asarray(resonance, jnp.float32)
    g = jnp.tan(math.pi * cutoff / float(sample_rate))
    k = jnp.maximum(2.0 * (1.0 - resonance * 0.97), 0.03)
    a1 = 1.0 / (1.0 + g * (g + k))
    a2 = g * a1
    a3 = g * a2
    one = jnp.ones_like(g)
    if filter_type == LOWPASS:
        m0, m1, m2 = 0.0 * one, 0.0 * one, one
    elif filter_type == BANDPASS:
        m0, m1, m2 = 0.0 * one, one, 0.0 * one
    elif filter_type == HIGHPASS:
        m0, m1, m2 = one, -k, -one
    else:
        raise ValueError(f"unknown svf type {filter_type!r}")
    return TptCoefficients(a1, a2, a3, m0, m1, m2)


def tpt_process(state: TptState, x, coefs: TptCoefficients, axis: int = -1, dtype=jnp.float32):
    """Run the TPT core over a block.  ``x`` has samples along ``axis``;
    coefficient fields broadcast against x (scalars or per-sample arrays).
    Returns ``(new_state, y)``."""
    x = jnp.asarray(x)
    in_dtype = x.dtype
    xs = jnp.moveaxis(x.astype(dtype), axis, -1)

    def prep(c):
        c = jnp.asarray(c, dtype)
        return jnp.moveaxis(c, axis, -1) if c.ndim == x.ndim else c

    a1, a2, a3, m0, m1, m2 = map(prep, coefs)
    ic1_0 = state.ic1.astype(dtype)
    ic2_0 = state.ic2.astype(dtype)

    s1, s2 = linear_recurrence_2(
        2.0 * a1 - 1.0,
        -2.0 * a2 + jnp.zeros_like(xs),
        2.0 * a2 + jnp.zeros_like(xs),
        1.0 - 2.0 * a3,
        2.0 * a2 * xs,
        2.0 * a3 * xs,
        ic1_0,
        ic2_0,
    )
    # The filter taps v1/v2 are the trapezoidal midpoints of consecutive
    # integrator states: ic' = 2v - ic  =>  v = (ic' + ic) / 2.
    def prev_seq(s, s0):
        s0 = jnp.broadcast_to(s0[..., None], s[..., :1].shape)
        return jnp.concatenate([s0, s[..., :-1]], axis=-1)

    v1 = 0.5 * (s1 + prev_seq(s1, ic1_0))
    v2 = 0.5 * (s2 + prev_seq(s2, ic2_0))
    y = m0 * xs + m1 * v1 + m2 * v2

    new_state = TptState(s1[..., -1], s2[..., -1])
    y = jnp.moveaxis(y, -1, axis)
    return new_state, y.astype(in_dtype)


# ---------------------------------------------------------------------------
# DC blocker (src/utils/dsp/filters/dc.rs)
# ---------------------------------------------------------------------------

DC_MODE_HZ = {"slow": 1.0, "default": 5.0, "fast": 20.0}


class DcState(NamedTuple):
    y1: jnp.ndarray
    x1: jnp.ndarray


def dc_state_init(shape=(), dtype=jnp.float32) -> DcState:
    return DcState(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))


def dc_coefficient(sample_rate: int, mode: str = "default") -> float:
    """r = 1 - tau*hz/sr (reference: src/utils/dsp/filters/dc.rs:60-66)."""
    return 1.0 - (2.0 * math.pi * DC_MODE_HZ[mode] / float(sample_rate))


def dc_process(state: DcState, x, r: float, axis: int = -1, dtype=jnp.float32):
    """y[n] = x[n] - x[n-1] + r*y[n-1]; feedforward diff is vectorised, the
    feedback is one parallel first-order scan."""
    x = jnp.asarray(x)
    in_dtype = x.dtype
    xs = jnp.moveaxis(x.astype(dtype), axis, -1)
    x_prev = jnp.concatenate(
        [jnp.broadcast_to(state.x1.astype(dtype)[..., None], xs[..., :1].shape), xs[..., :-1]],
        axis=-1,
    )
    diff = xs - x_prev
    y = linear_recurrence(jnp.full_like(xs, r), diff, state.y1.astype(dtype))
    new_state = DcState(y1=y[..., -1], x1=xs[..., -1])
    y = jnp.moveaxis(y, -1, axis) if axis != -1 else y
    return new_state, y.astype(in_dtype)
