"""Block parameter smoothers with exact reference trajectories.

Behavioural spec: reference src/utils/smoothing.rs.

The reference smooths parameters with per-sample stateful ramps
(exponential ``c += (t-c)*inertia*comp``, linear fixed-step, critically-damped
spring).  A per-sample loop would serialize the block, so each smoother here is
evaluated in closed form: scheduled events split a block into at most K+1
segments; a tiny ``lax.scan`` over segments propagates the smoother state to
each segment start, then the per-sample trajectory inside every segment is an
analytic function of the sample index (exponential decay / affine ramp /
2x2-eigenvalue power), fully vectorised over the block.

The reference's ramp-termination ("snap") rule is modelled exactly for the
exponential and linear smoothers: ramping stops once the per-sample increment
falls below ``100 * f32::EPSILON`` (src/utils/smoothing.rs:196-216), after
which the *output* is the target while the internal state stays frozen —
subsequent events ramp from the frozen value.

Event representation per block (``SegmentEvents``):
  times:  int32[K]  frame index where the event takes effect (>= block length
                    for unused slots; ascending)
  values: float32[K] new target value
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SMOOTHER_EPSILON, SMOOTHER_REFERENCE_SR


class SegmentEvents(NamedTuple):
    times: jax.Array  # int32[K]
    values: jax.Array  # float32[K]


def no_events(max_events: int, block_frames: int) -> SegmentEvents:
    return SegmentEvents(
        times=jnp.full((max_events,), block_frames, jnp.int32),
        values=jnp.zeros((max_events,), jnp.float32),
    )


def exp_alpha(inertia: float, sample_rate: int) -> float:
    """Effective per-sample coefficient: inertia scaled by the 44.1 kHz
    reference-rate compensation (src/utils/smoothing.rs:150)."""
    return inertia * (SMOOTHER_REFERENCE_SR / float(sample_rate))


# ---------------------------------------------------------------------------
# Exponential smoother (src/utils/smoothing.rs:122-233)
# ---------------------------------------------------------------------------


class ExpSmootherState(NamedTuple):
    current: jax.Array  # f32 scalar (or batched)
    target: jax.Array


def exp_smoother_init(value) -> ExpSmootherState:
    value = jnp.asarray(value, jnp.float32)
    return ExpSmootherState(current=value, target=value)


def _exp_steps_to_freeze(delta, alpha, log1ma):
    """Number of ramp steps until |delta| * alpha * (1-alpha)^n <= eps.

    n* = ceil(log(eps / (alpha*|delta|)) / log(1-alpha)), clamped >= 0.
    Returns float32 (compared against sample indices).
    """
    ad = alpha * jnp.abs(delta)
    n = jnp.ceil(jnp.log(jnp.maximum(SMOOTHER_EPSILON / jnp.maximum(ad, 1e-38), 1e-38)) / log1ma)
    # If already below threshold, no steps at all.
    return jnp.where(ad <= SMOOTHER_EPSILON, 0.0, jnp.maximum(n, 0.0))


def exp_smoother_block(
    state: ExpSmootherState,
    events: SegmentEvents,
    block_frames: int,
    alpha: float,
):
    """Render ``block_frames`` smoothed values, applying events sample-
    accurately.  Returns ``(new_state, values[block_frames])``.

    Matches ``next()`` semantics: the value at output sample n is the state
    *after* ramping at n (src/utils/smoothing.rs:21-28), and the output equals
    the target exactly once ramping has terminated.
    """
    n = block_frames
    alpha = jnp.float32(alpha)
    log1ma = jnp.log1p(-alpha)

    k = events.times.shape[0]
    # Segment k (0..K) starts at seg_start[k] and has target seg_target[k].
    seg_start = jnp.concatenate([jnp.zeros((1,), jnp.int32), events.times])
    seg_target = jnp.concatenate([state.target[None], events.values])
    # Masked events (time >= n) keep the previous target.
    valid = seg_start < n
    # Carry the last valid target forward over masked slots.
    def carry_fwd(prev, xs):
        tgt, ok = xs
        cur = jnp.where(ok, tgt, prev)
        return cur, cur

    _, seg_target = jax.lax.scan(
        carry_fwd, seg_target[0], (seg_target, valid), unroll=True
    )
    seg_len = jnp.diff(jnp.concatenate([seg_start, jnp.array([n], jnp.int32)]))

    # Propagate the smoother state across segments.  Only *real* events run
    # set_target's snap-to-target; the continuation segment and masked pad
    # slots keep the frozen internal state (src/utils/smoothing.rs:221-226).
    is_event = jnp.concatenate([jnp.zeros((1,), bool), valid[1:]])

    def seg_step(carry, xs):
        cur, = carry
        tgt, length, ev = xs
        delta = cur - tgt
        n_freeze = _exp_steps_to_freeze(delta, alpha, log1ma)
        cur = jnp.where(ev & (n_freeze == 0.0), tgt, cur)
        delta = cur - tgt
        steps = jnp.minimum(length.astype(jnp.float32), n_freeze)
        cur_end = tgt + delta * jnp.exp(log1ma * steps)
        return (cur_end,), (cur, tgt, n_freeze)

    (_,), (seg_cur0, seg_tgt, seg_nfreeze) = jax.lax.scan(
        seg_step, (state.current,), (seg_target, seg_len, is_event), unroll=True
    )

    # Per-sample evaluation as a sum of K statically-indexed segment terms:
    # pure elementwise work, no searchsorted or per-sample gathers.
    idx = jnp.arange(n, dtype=jnp.float32)
    segs = seg_start.astype(jnp.float32)
    seg_end = jnp.concatenate(
        [seg_start[1:], jnp.array([n], jnp.int32)]).astype(jnp.float32)
    out = jnp.zeros((n,), jnp.float32)
    for s in range(seg_start.shape[0]):  # static unroll, K is small
        j1 = idx - segs[s] + 1.0  # j + 1 for this segment's local index
        mask = (j1 > 0.0) & (idx < seg_end[s])
        ramped = seg_tgt[s] + (seg_cur0[s] - seg_tgt[s]) * jnp.exp(
            log1ma * jnp.maximum(j1, 0.0))
        val = jnp.where(j1 <= seg_nfreeze[s], ramped, seg_tgt[s])
        out = out + jnp.where(mask, val, 0.0)

    final_steps = jnp.minimum(seg_len[-1].astype(jnp.float32), seg_nfreeze[-1])
    final_cur = seg_tgt[-1] + (seg_cur0[-1] - seg_tgt[-1]) * jnp.exp(log1ma * final_steps)
    new_state = ExpSmootherState(current=final_cur, target=seg_tgt[-1])
    return new_state, out


# ---------------------------------------------------------------------------
# Linear smoother (src/utils/smoothing.rs:238-420)
# ---------------------------------------------------------------------------


class LinSmootherState(NamedTuple):
    current: jax.Array
    target: jax.Array
    step: jax.Array  # signed per-sample step currently in effect
    pending: jax.Array  # float32 count of remaining ramp steps


def lin_smoother_init(value, step: float = 0.01, sample_rate: int = 48000) -> LinSmootherState:
    value = jnp.asarray(value, jnp.float32)
    comp = SMOOTHER_REFERENCE_SR / float(sample_rate)
    return LinSmootherState(
        current=value,
        target=value,
        step=jnp.full_like(value, step * comp),
        pending=jnp.zeros_like(value),
    )


def lin_smoother_block(
    state: LinSmootherState,
    events: SegmentEvents,
    block_frames: int,
):
    """Linear fixed-step ramps.  ``set_target`` recomputes the signed step and
    a rounded pending-step count; the final step snaps exactly to the target
    (src/utils/smoothing.rs:300-380)."""
    n = block_frames
    step_mag = jnp.abs(state.step)

    seg_start = jnp.concatenate([jnp.zeros((1,), jnp.int32), events.times])
    valid = seg_start < n
    raw_tgt = jnp.concatenate([state.target[None], events.values])

    def carry_fwd(prev, xs):
        tgt, ok = xs
        cur = jnp.where(ok, tgt, prev)
        return cur, cur

    _, seg_target = jax.lax.scan(carry_fwd, raw_tgt[0], (raw_tgt, valid), unroll=True)
    seg_len = jnp.diff(jnp.concatenate([seg_start, jnp.array([n], jnp.int32)]))

    def seg_step(carry, xs):
        cur, pending, sgnstep = carry
        tgt, length, ev = xs
        # Only real events recompute the ramp (set_target,
        # src/utils/smoothing.rs:300-340); the continuation segment and
        # masked pad slots keep the in-flight ramp.
        new_sgnstep = jnp.where(cur > tgt, -step_mag, step_mag)
        new_pending = jnp.maximum(jnp.round((tgt - cur) / new_sgnstep), 0.0)
        sgnstep = jnp.where(ev, new_sgnstep, sgnstep)
        pending = jnp.where(ev, new_pending, pending)
        cur = jnp.where(ev & (pending == 0.0), tgt, cur)
        steps = jnp.minimum(length.astype(jnp.float32), pending)
        cur_end = jnp.where(
            (steps >= pending) & (pending > 0.0), tgt, cur + sgnstep * steps
        )
        return (cur_end, pending - steps, sgnstep), (cur, tgt, pending, sgnstep)

    is_event = jnp.concatenate([jnp.zeros((1,), bool), valid[1:]])
    (cur_end, pend_end, step_end), (seg_cur0, seg_tgt, seg_pending, seg_sgnstep) = jax.lax.scan(
        seg_step,
        (state.current, state.pending, state.step),
        (seg_target, seg_len, is_event),
        unroll=True,
    )

    # Gather-free per-sample evaluation (see exp_smoother_block).
    idx = jnp.arange(n, dtype=jnp.float32)
    segs = seg_start.astype(jnp.float32)
    seg_end = jnp.concatenate(
        [seg_start[1:], jnp.array([n], jnp.int32)]).astype(jnp.float32)
    out = jnp.zeros((n,), jnp.float32)
    for s in range(seg_start.shape[0]):  # static unroll, K is small
        j1 = idx - segs[s] + 1.0
        mask = (j1 > 0.0) & (idx < seg_end[s])
        ramped = seg_cur0[s] + seg_sgnstep[s] * j1
        val = jnp.where(j1 < seg_pending[s], ramped, seg_tgt[s])
        out = out + jnp.where(mask, val, 0.0)

    new_state = LinSmootherState(
        current=cur_end, target=seg_tgt[-1], step=step_end, pending=pend_end
    )
    return new_state, out


# ---------------------------------------------------------------------------
# Spring smoother (src/utils/smoothing.rs:424-545)
# ---------------------------------------------------------------------------


class SpringSmootherState(NamedTuple):
    current: jax.Array
    velocity: jax.Array
    target: jax.Array


def spring_smoother_init(value) -> SpringSmootherState:
    value = jnp.asarray(value, jnp.float32)
    return SpringSmootherState(
        current=value, velocity=jnp.zeros_like(value), target=value
    )


def spring_omega(duration_samples: float = 4410.0) -> float:
    """~100 ms default; (1+5.5)e^-5.5 ~= 3% settling
    (src/utils/smoothing.rs:440-447)."""
    return 5.5 / float(duration_samples)


def spring_smoother_block(
    state: SpringSmootherState,
    events: SegmentEvents,
    block_frames: int,
    omega: float,
    sample_rate: int,
):
    """Critically-damped spring: per-sample update
    ``v += (t-c)k - v d; c += v`` with k=w'^2, d=2w'
    (src/utils/smoothing.rs:512-520).  Evaluated in closed form via the
    eigen-decomposition of the 2x2 update matrix on (v, c-t).

    Deviation from the reference: the ramp-termination epsilon check is
    applied per-sample on the analytic trajectory instead of freezing the
    internal state; the difference is O(100*f32::EPSILON) on an already
    settled value.  Spring smoothing is only used for delay-time modulation.
    """
    n = block_frames
    w = omega * (SMOOTHER_REFERENCE_SR / float(sample_rate))
    k = w * w
    d = 2.0 * w
    # Update matrix on (v, e) with e = current - target:
    #   v' = (1-d) v - k e ;  e' = v' + e
    m11, m12 = 1.0 - d, -k
    m21, m22 = 1.0 - d, 1.0 - k
    tr = m11 + m22
    disc = math.sqrt(max(tr * tr - 4.0 * (1.0 - d), 0.0))
    l1 = (tr + disc) / 2.0
    l2 = (tr - disc) / 2.0
    inv_dl = 1.0 / (l1 - l2) if disc > 0 else 0.0

    def mat_pow_apply(p, v0, e0):
        """(v_p, e_p) = M^p (v0, e0) via M^p = (l1^p (M-l2 I) - l2^p (M-l1 I)) / (l1-l2)."""
        l1p = jnp.exp(jnp.log(jnp.float32(l1)) * p) if l1 > 0 else jnp.float32(l1) ** p
        l2p = jnp.sign(jnp.float32(l2)) ** p * jnp.exp(
            jnp.log(jnp.abs(jnp.float32(l2)) + 1e-38) * p
        )
        c1 = l1p * inv_dl
        c2 = l2p * inv_dl
        # M - l2 I and M - l1 I applied to (v0, e0)
        a_v = (m11 - l2) * v0 + m12 * e0
        a_e = m21 * v0 + (m22 - l2) * e0
        b_v = (m11 - l1) * v0 + m12 * e0
        b_e = m21 * v0 + (m22 - l1) * e0
        return c1 * a_v - c2 * b_v, c1 * a_e - c2 * b_e

    seg_start = jnp.concatenate([jnp.zeros((1,), jnp.int32), events.times])
    valid = seg_start < n
    raw_tgt = jnp.concatenate([state.target[None], events.values])

    def carry_fwd(prev, xs):
        tgt, ok = xs
        cur = jnp.where(ok, tgt, prev)
        return cur, cur

    _, seg_target = jax.lax.scan(carry_fwd, raw_tgt[0], (raw_tgt, valid), unroll=True)
    seg_len = jnp.diff(jnp.concatenate([seg_start, jnp.array([n], jnp.int32)]))

    def seg_step(carry, xs):
        v, c = carry
        tgt, length = xs
        e = c - tgt  # set_target preserves velocity (src/utils/smoothing.rs:528-531)
        p = length.astype(jnp.float32)
        v_end, e_end = mat_pow_apply(p, v, e)
        return (v_end, tgt + e_end), (v, e, tgt)

    (v_end, c_end), (seg_v0, seg_e0, seg_tgt) = jax.lax.scan(
        seg_step, (state.velocity, state.current), (seg_target, seg_len), unroll=True
    )

    # Gather-free per-sample evaluation (see exp_smoother_block).
    idx = jnp.arange(n, dtype=jnp.float32)
    segs = seg_start.astype(jnp.float32)
    seg_end = jnp.concatenate(
        [seg_start[1:], jnp.array([n], jnp.int32)]).astype(jnp.float32)
    out = jnp.zeros((n,), jnp.float32)
    for s in range(seg_start.shape[0]):  # static unroll, K is small
        j1 = idx - segs[s] + 1.0
        mask = (j1 > 0.0) & (idx < seg_end[s])
        v_j, e_j = mat_pow_apply(jnp.maximum(j1, 0.0), seg_v0[s], seg_e0[s])
        settled = (jnp.abs(v_j) <= SMOOTHER_EPSILON) & (
            jnp.abs(e_j) <= SMOOTHER_EPSILON)
        val = jnp.where(settled, seg_tgt[s], seg_tgt[s] + e_j)
        out = out + jnp.where(mask, val, 0.0)

    new_state = SpringSmootherState(current=c_end, velocity=v_end, target=seg_tgt[-1])
    return new_state, out


def step_targets(current, events: SegmentEvents, ramps, n: int):
    """Un-smoothed per-sample targets for smoothing=None parameters: stepped
    at event times, or linearly interpolated across a segment when the event
    ending it is flagged as a ramp (speed glides, events.py).  Returns
    (end_value, values[n]).

    Evaluated as a sum of K basis terms (step or clipped-lerp per event)
    with statically-indexed coefficients: pure elementwise work, no
    gathers or searchsorted — per-voice automation stays nearly free.  value[i] = current + sum_k d_k * g_k(i), with d_k the value delta
    at event k and g_k a unit step (jump) or clipped ramp."""
    t = events.times  # [K], pads hold block_len
    valid = t < n

    def carry(cur, xs):
        v, ok = xs
        cur = jnp.where(ok, v, cur)
        return cur, cur

    cur0 = jnp.asarray(current, jnp.float32)
    _, after = jax.lax.scan(carry, cur0, (events.values, valid), unroll=True)
    seg_vals = jnp.concatenate([cur0[None], after])  # [K+1]
    d = seg_vals[1:] - seg_vals[:-1]  # [K]; 0 on padded slots
    prev_t = jnp.concatenate([jnp.zeros((1,), t.dtype), t[:-1]])
    inv_span = 1.0 / jnp.maximum(t - prev_t, 1).astype(jnp.float32)
    idx = jnp.arange(n, dtype=jnp.float32)
    vals = jnp.broadcast_to(current, (n,)).astype(jnp.float32)
    k_count = t.shape[0]
    for k in range(k_count):  # static unroll, K is small
        ramp_g = jnp.clip((idx - prev_t[k]) * inv_span[k], 0.0, 1.0)
        jump_g = (idx >= t[k]).astype(jnp.float32)
        vals = vals + d[k] * jnp.where(ramps[k] > 0, ramp_g, jump_g)
    return seg_vals[-1], vals

