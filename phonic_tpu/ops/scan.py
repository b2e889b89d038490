"""Parallel evaluation of linear recurrences.

This is the substrate that lets every recursive DSP unit in the reference
(one-pole smoothers src/utils/smoothing.rs, biquads
src/utils/dsp/filters/biquad.rs, DC filters src/utils/dsp/filters/dc.rs,
envelope followers src/utils/dsp/envelope.rs) run as a *parallel* program
instead of a per-sample loop: a first- or second-order recurrence
``s[n] = A[n] s[n-1] + b[n]`` is an associative composition, so a block of N
samples evaluates in O(log N) depth.

Two evaluation strategies, routed by block length:

- short blocks: ``lax.associative_scan`` (log-depth odd/even sweeps);
- long blocks (>= _CHUNKED_MIN_T): a two-level chunked evaluation
  (:func:`_chunked_first` / :func:`_chunked_second`) — reshape T into
  [M, L] chunks, one short ``lax.scan`` over L with every chunk advanced
  in parallel (carrying the zero-state response and the cumulative
  coefficient), a second short scan threading chunk boundaries, and an
  elementwise combine.  The associative scan's strided sweeps move the
  whole block at each of log2(T) levels and grow linearly with vmapped
  lanes; the chunked form's scan bodies are elementwise over batch x
  chunks, so the lanes ride along in each step.

Time-varying coefficients are free: every element carries its own ``A[n]``,
which directly solves parameter-ramped filters (the reference recomputes
biquad coefficients per frame while ramping, src/effect/filter.rs:160-196).

For *stable* filters the recurrence is contractive, so the scan's f32
rounding error stays bounded (long-range products decay geometrically);
tests/test_biquad.py validates < -90 dB error vs SciPy float64.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Minimum block length for the two-level chunked evaluation.  Below this the
# associative scan is fine; above it the associative scan's log2(T) levels of
# stride-2^k slicing move the whole block at every level, while the chunked
# form's two short scans have elementwise bodies that batch flat.
_CHUNKED_MIN_T = 4096


def _chunk_split(t: int) -> int:
    """Within-chunk length L ~ sqrt(t) (power of two), minimising the total
    sequential steps L + ceil(t/L) of the two-level evaluation."""
    return 1 << (t.bit_length() // 2)


def _chunked_first(a, b, y0):
    """Two-level evaluation of ``y[n] = a[n] y[n-1] + b[n]`` along the last
    axis.  Reshapes T into [M, L] chunks; a short ``lax.scan`` over L runs
    every chunk's recurrence from zero state (carrying the cumulative
    coefficient product), a second scan over M threads the carry between
    chunks, and an elementwise combine restores the exact solution:

        y[m, l] = w[m, l] + p[m, l] * c[m-1]

    where w is the zero-state (particular) response, p the cumulative
    product of a within the chunk, and c the chunk-boundary state.  Both
    scan bodies are elementwise over all batch dims x chunks, so the cost
    is ~(L + M) steps of loop overhead regardless of lanes/channels — the
    associative scan this replaces moves strided data at every one of its
    log2(T) levels and scales linearly with the batch.
    """
    t = b.shape[-1]
    l = _chunk_split(t)
    m = -(-t // l)
    if m * l != t:
        pad = m * l - t
        a = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)],
                    constant_values=1)
        b = jnp.pad(b, [(0, 0)] * (b.ndim - 1) + [(0, pad)])
    lead = b.shape[:-1]
    ar = jnp.moveaxis(a.reshape(lead + (m, l)), -1, 0)  # [L, ..., M]
    br = jnp.moveaxis(b.reshape(lead + (m, l)), -1, 0)

    def step(carry, inp):
        w, p = carry
        a_n, b_n = inp
        w = a_n * w + b_n
        p = p * a_n
        return (w, p), (w, p)

    w0 = jnp.zeros_like(br[0])
    p0 = jnp.ones_like(ar[0])
    (w_end, p_end), (ws, ps) = jax.lax.scan(step, (w0, p0), (ar, br))

    def cstep(c, inp):
        pe, we = inp
        c = pe * c + we
        return c, c

    y0b = jnp.broadcast_to(jnp.asarray(y0, b.dtype), w_end.shape[:-1])
    _, cs = jax.lax.scan(
        cstep, y0b,
        (jnp.moveaxis(p_end, -1, 0), jnp.moveaxis(w_end, -1, 0)))
    cs = jnp.moveaxis(cs, 0, -1)  # [..., M]
    c_prev = jnp.concatenate([y0b[..., None], cs[..., :-1]], axis=-1)
    y = ws + ps * c_prev  # [L, ..., M] broadcast [..., M]
    y = jnp.moveaxis(y, 0, -1).reshape(lead + (m * l,))
    return y[..., :t]


def _chunked_second(a11, a12, a21, a22, b1, b2, s0_1, s0_2):
    """Two-level evaluation of the 2-vector recurrence (see
    :func:`_chunked_first`); the cumulative coefficient is a 2x2 matrix
    product tracked as four scalars."""
    t = b1.shape[-1]
    l = _chunk_split(t)
    m = -(-t // l)
    if m * l != t:
        pad = m * l - t
        padx = [(0, 0)] * (b1.ndim - 1) + [(0, pad)]
        # pad with A = I, b = 0: state flows through unchanged
        a11 = jnp.pad(a11, padx, constant_values=1)
        a12 = jnp.pad(a12, padx)
        a21 = jnp.pad(a21, padx)
        a22 = jnp.pad(a22, padx, constant_values=1)
        b1 = jnp.pad(b1, padx)
        b2 = jnp.pad(b2, padx)
    lead = b1.shape[:-1]

    def chunked(x):
        return jnp.moveaxis(x.reshape(lead + (m, l)), -1, 0)  # [L, ..., M]

    xs = tuple(chunked(x) for x in (a11, a12, a21, a22, b1, b2))

    def step(carry, inp):
        w1, w2, p11, p12, p21, p22 = carry
        c11, c12, c21, c22, d1, d2 = inp
        w1n = c11 * w1 + c12 * w2 + d1
        w2n = c21 * w1 + c22 * w2 + d2
        q11 = c11 * p11 + c12 * p21
        q12 = c11 * p12 + c12 * p22
        q21 = c21 * p11 + c22 * p21
        q22 = c21 * p12 + c22 * p22
        out = (w1n, w2n, q11, q12, q21, q22)
        return out, out

    z = jnp.zeros_like(xs[4][0])
    one = jnp.ones_like(xs[0][0])
    init = (z, z, one, 0.0 * one, 0.0 * one, one)
    ends, seq = jax.lax.scan(step, init, xs)
    w1e, w2e, p11e, p12e, p21e, p22e = ends  # [..., M]
    ws1, ws2, ps11, ps12, ps21, ps22 = seq  # [L, ..., M]

    def cstep(c, inp):
        c1, c2 = c
        p11, p12, p21, p22, w1, w2 = inp
        n1 = p11 * c1 + p12 * c2 + w1
        n2 = p21 * c1 + p22 * c2 + w2
        return (n1, n2), (n1, n2)

    lead_m = w1e.shape[:-1]
    c1_0 = jnp.broadcast_to(jnp.asarray(s0_1, b1.dtype), lead_m)
    c2_0 = jnp.broadcast_to(jnp.asarray(s0_2, b2.dtype), lead_m)
    _, (cs1, cs2) = jax.lax.scan(
        cstep, (c1_0, c2_0),
        tuple(jnp.moveaxis(x, -1, 0)
              for x in (p11e, p12e, p21e, p22e, w1e, w2e)))
    cs1 = jnp.moveaxis(cs1, 0, -1)
    cs2 = jnp.moveaxis(cs2, 0, -1)
    c1_prev = jnp.concatenate([c1_0[..., None], cs1[..., :-1]], axis=-1)
    c2_prev = jnp.concatenate([c2_0[..., None], cs2[..., :-1]], axis=-1)
    s1 = ws1 + ps11 * c1_prev + ps12 * c2_prev
    s2 = ws2 + ps21 * c1_prev + ps22 * c2_prev
    s1 = jnp.moveaxis(s1, 0, -1).reshape(lead + (m * l,))[..., :t]
    s2 = jnp.moveaxis(s2, 0, -1).reshape(lead + (m * l,))[..., :t]
    return s1, s2


def linear_recurrence(a, b, y0, axis: int = -1, reverse: bool = False):
    """Solve ``y[n] = a[n] * y[n-1] + b[n]`` with ``y[-1] = y0``.

    a, b: broadcastable arrays with the recurrence along ``axis``.
    y0: initial state, shaped like a/b without ``axis``.
    Returns y with the same shape as ``b``.
    """
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    a, b = jnp.broadcast_arrays(a, b)
    if axis != -1:
        a = jnp.moveaxis(a, axis, -1)
        b = jnp.moveaxis(b, axis, -1)

    if not reverse and b.shape[-1] >= _CHUNKED_MIN_T:
        y = _chunked_first(a, b, y0)
        if axis != -1:
            y = jnp.moveaxis(y, -1, axis)
        return y

    # Fold the initial state into the first element: b[0] += a[0] * y0.
    y0 = jnp.asarray(y0, b.dtype)
    first = b[..., 0] + a[..., 0] * y0
    b = jnp.concatenate([first[..., None], b[..., 1:]], axis=-1)

    def combine(lhs, rhs):
        a_l, b_l = lhs
        a_r, b_r = rhs
        return a_r * a_l, a_r * b_l + b_r

    _, y = jax.lax.associative_scan(combine, (a, b), axis=-1, reverse=reverse)
    if axis != -1:
        y = jnp.moveaxis(y, -1, axis)
    return y


def linear_recurrence_2(a11, a12, a21, a22, b1, b2, s0_1, s0_2, axis: int = -1):
    """Solve the 2-vector recurrence ``s[n] = A[n] s[n-1] + b[n]``.

    All six coefficient arrays share the recurrence ``axis``.  The 2x2
    composition is expanded into scalar ops so everything stays elementwise
    (no tiny matmuls).  Returns (s1, s2) along the axis.
    """
    arrs = jnp.broadcast_arrays(a11, a12, a21, a22, b1, b2)
    if axis != -1:
        arrs = [jnp.moveaxis(x, axis, -1) for x in arrs]
    a11, a12, a21, a22, b1, b2 = arrs

    if b1.shape[-1] >= _CHUNKED_MIN_T:
        s1, s2 = _chunked_second(a11, a12, a21, a22, b1, b2, s0_1, s0_2)
        if axis != -1:
            s1 = jnp.moveaxis(s1, -1, axis)
            s2 = jnp.moveaxis(s2, -1, axis)
        return s1, s2

    s0_1 = jnp.asarray(s0_1, b1.dtype)
    s0_2 = jnp.asarray(s0_2, b2.dtype)
    first1 = b1[..., 0] + a11[..., 0] * s0_1 + a12[..., 0] * s0_2
    first2 = b2[..., 0] + a21[..., 0] * s0_1 + a22[..., 0] * s0_2
    b1 = jnp.concatenate([first1[..., None], b1[..., 1:]], axis=-1)
    b2 = jnp.concatenate([first2[..., None], b2[..., 1:]], axis=-1)

    def combine(lhs, rhs):
        l11, l12, l21, l22, lb1, lb2 = lhs
        r11, r12, r21, r22, rb1, rb2 = rhs
        # A = A_r @ A_l ; b = A_r @ b_l + b_r
        c11 = r11 * l11 + r12 * l21
        c12 = r11 * l12 + r12 * l22
        c21 = r21 * l11 + r22 * l21
        c22 = r21 * l12 + r22 * l22
        cb1 = r11 * lb1 + r12 * lb2 + rb1
        cb2 = r21 * lb1 + r22 * lb2 + rb2
        return c11, c12, c21, c22, cb1, cb2

    out = jax.lax.associative_scan(
        combine, (a11, a12, a21, a22, b1, b2), axis=-1
    )
    s1, s2 = out[4], out[5]
    if axis != -1:
        s1 = jnp.moveaxis(s1, -1, axis)
        s2 = jnp.moveaxis(s2, -1, axis)
    return s1, s2


def linear_recurrence_reference(a, b, y0, axis: int = -1):
    """Sequential ``lax.scan`` version of :func:`linear_recurrence` — the
    correctness oracle for tests and a fallback for very short blocks."""
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    a, b = jnp.broadcast_arrays(a, b)
    if axis != -1:
        a = jnp.moveaxis(a, axis, -1)
        b = jnp.moveaxis(b, axis, -1)
    y0 = jnp.broadcast_to(jnp.asarray(y0, b.dtype), b.shape[:-1])

    def step(carry, ab):
        a_n, b_n = ab
        y = a_n * carry + b_n
        return y, y

    _, y = jax.lax.scan(step, y0, (jnp.moveaxis(a, -1, 0), jnp.moveaxis(b, -1, 0)))
    y = jnp.moveaxis(y, 0, -1)
    if axis != -1:
        y = jnp.moveaxis(y, -1, axis)
    return y
