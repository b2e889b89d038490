"""Stereo dub delay with filtered, saturated feedback and LFO modulation.

Behavioural spec: reference src/effect/delay.rs — modes Stereo / PingPong
(:48-60); spring-smoothed delay time up to 4000 ms; feedback path =
SVF filter -> tanh-approx saturation -> DC blocker -> clamp(+-4)
(:224-248); LFO (7 waveforms) modulating time (+-50 ms), feedback and
filter cutoff (:340-380); equal-power-ish dry/wet law and mid/side stereo
width on the output (:440-452); analytic tail from the feedback factor.

Formulation (see ops/ring.py): N-frame blocks run as a scan over
sub-blocks of B samples (B chosen from the smallest reachable delay); inside
a sub-block everything is vectorised — fractional ring reads, the SVF as a
mini parallel scan with per-sample modulated coefficients, elementwise
saturation, a first-order DC scan, then one contiguous ring write.  Runtime
delay times are clamped to >= B+1 samples; construct with a smaller
``min_delay_ms`` if automation needs to reach shorter delays (costs scan
steps), and with a smaller ``max_delay_capacity_ms`` when automation never
exceeds it (shrinks the chronological line and its per-step read window —
the default allocates the reference's full 4000 ms range).

The LFO uses this engine's deterministic counter-seeded RNG for the random
waveforms (the reference's is OS-seeded and irreproducible).
"""

from __future__ import annotations

import math

import numpy as np
import jax
import jax.numpy as jnp

from ..graph.nodes import BuildCtx, Effect
from ..ops import chrono as chrono_ops, filters, lfo as lfo_ops, ring as ring_ops
from ..params import (
    EnumParameter, ExponentialScaling, FloatParameter, format_degrees,
    format_percent,
)

MAX_DELAY_MS = 4000.0
MAX_LFO_TIME_MOD_MS = 50.0
FILTER_RESONANCE = 0.302  # Q ~= 0.7071 (delay.rs:120)

MODE = EnumParameter("mode", "Mode", ("Stereo", "Ping Pong"), "Stereo")
DELAY_TIME = FloatParameter(
    "dlay", "Delay", 1.0, MAX_DELAY_MS, 375.0, unit="ms",
    smoothing="spring", smoothing_arg=20000.0,
)
FEEDBACK = FloatParameter("fdbk", "Feedback", 0.0, 1.0, 0.5, formatter=format_percent)
FILTER_TYPE = EnumParameter("ftyp", "Filter Type", ("Lowpass", "Highpass", "Bandpass"), "Lowpass")
FILTER_CUTOFF = FloatParameter(
    "cuto", "Filter Cutoff", 20.0, 20000.0, 6000.0, unit="Hz",
    scaling=ExponentialScaling(2.5),
)
DRIVE = FloatParameter("driv", "Drive", 0.0, 1.0, 0.0, formatter=format_percent)
WET = FloatParameter("wet_", "Wet", 0.0, 1.0, 0.5, formatter=format_percent)
WIDTH = FloatParameter("wdth", "Width", 0.0, 1.0, 0.5, formatter=format_percent)
LFO_RATE = FloatParameter(
    "lfor", "LFO Rate", 0.01, 10.0, 1.0, unit="Hz", scaling=ExponentialScaling(2.0)
)
LFO_SHAPE = EnumParameter("lfos", "LFO Shape", lfo_ops.WAVEFORM_NAMES, "Sine")
LFO_TIME = FloatParameter("lfdt", "LFO -> Time", -1.0, 1.0, 0.0, formatter=format_percent)
LFO_FB = FloatParameter("ldfb", "LFO -> Feedback", -1.0, 1.0, 0.0, formatter=format_percent)
LFO_FILTER = FloatParameter("lfdf", "LFO -> Filter", -1.0, 1.0, 0.0, formatter=format_percent)

_SVF_TYPES = (filters.LOWPASS, filters.HIGHPASS, filters.BANDPASS)


def saturate(x, drive):
    """tanh-approx soft clip x(27+x^2)/(27+9x^2), gain-scaled by drive
    (reference: delay.rs:69-79)."""
    gain = 1.0 + drive * 4.0
    xg = x * gain
    x2 = xg * xg
    out = xg * (27.0 + x2) / (27.0 + 9.0 * x2) / jnp.sqrt(gain)
    return jnp.where(drive < 0.001, x, out)


class DelayEffect(Effect):
    PARAMS = (MODE, DELAY_TIME, FEEDBACK, FILTER_TYPE, FILTER_CUTOFF, DRIVE,
              WET, WIDTH, LFO_RATE, LFO_SHAPE, LFO_TIME, LFO_FB, LFO_FILTER)
    WEIGHT = 3

    def __init__(self, mode: str = "Stereo", delay_ms: float = 375.0,
                 feedback: float = 0.5, filter_type: str = "Lowpass",
                 filter_cutoff: float = 6000.0, drive: float = 0.0,
                 wet: float = 0.5, width: float = 0.5, lfo_rate: float = 1.0,
                 lfo_shape: str = "Sine", lfo_to_time: float = 0.0,
                 lfo_to_feedback: float = 0.0, lfo_to_filter: float = 0.0,
                 min_delay_ms: float = 40.0,
                 max_delay_capacity_ms: float = MAX_DELAY_MS,
                 seed: int = 0x5EED, name=None):
        super().__init__(name)
        self.mode = mode
        self.delay_ms = float(delay_ms)
        self.feedback = float(feedback)
        self.filter_type = filter_type
        self.filter_cutoff = float(filter_cutoff)
        self.drive = float(drive)
        self.wet = float(wet)
        self.width = float(width)
        self.lfo_rate = float(lfo_rate)
        self.lfo_shape = lfo_shape
        self.lfo_to_time = float(lfo_to_time)
        self.lfo_to_feedback = float(lfo_to_feedback)
        self.lfo_to_filter = float(lfo_to_filter)
        self.min_delay_ms = float(min_delay_ms)
        # capacity hint (like min_delay_ms, but for the top of the range):
        # the delay line is allocated for this many ms and runtime DELAY_TIME
        # automation clamps to it.  The default keeps the reference's full
        # 4000 ms range (delay.rs allocates MAX_DELAY upfront); declaring a
        # smaller capacity shrinks the per-step read window of the
        # chronological line (ops/chrono.read_frac cost is linear in it).
        self.max_delay_capacity_ms = float(
            np.clip(max_delay_capacity_ms, delay_ms, MAX_DELAY_MS))
        self.seed = seed

    def param_initials(self):
        return {
            MODE.id: MODE.index_of(self.mode), DELAY_TIME.id: self.delay_ms,
            FEEDBACK.id: self.feedback,
            FILTER_TYPE.id: FILTER_TYPE.index_of(self.filter_type),
            FILTER_CUTOFF.id: self.filter_cutoff, DRIVE.id: self.drive,
            WET.id: self.wet, WIDTH.id: self.width, LFO_RATE.id: self.lfo_rate,
            LFO_SHAPE.id: LFO_SHAPE.index_of(self.lfo_shape),
            LFO_TIME.id: self.lfo_to_time, LFO_FB.id: self.lfo_to_feedback,
            LFO_FILTER.id: self.lfo_to_filter,
        }

    def _subblock(self, ctx: BuildCtx) -> int:
        # the per-step SVF/DC recurrences are op-count-bound (each
        # associative-scan stage pays ~µs of op overhead regardless of
        # width), so fewer, larger sub-blocks are strictly cheaper; the
        # only ceiling is the min reachable delay (reads must stay behind
        # the current step's writes).  cap=8192 instead of the default
        # 2048: a min_delay_ms hint of 200+ ms cuts the step count 8x.
        min_delay = self.min_delay_ms * ctx.sample_rate / 1000.0
        return ring_ops.pick_subblock(min_delay, ctx.block_frames, cap=8192)

    def batch_key(self, ctx: BuildCtx):
        # sub-block size, line capacity and the LFO RNG seed are baked in
        return (type(self).__name__, self._subblock(ctx),
                self._max_offset(ctx), self.seed)

    def _max_offset(self, ctx: BuildCtx) -> int:
        return int(math.ceil(
            (self.max_delay_capacity_ms + MAX_LFO_TIME_MOD_MS)
            * ctx.sample_rate / 1000.0
        )) + 4

    def _slab_rows(self, ctx: BuildCtx) -> int:
        """Row-slab height for the grouped window read: bounds any
        128-output group's read-position span.  The delay offset is the
        spring-smoothed DELAY_TIME (critically damped, max |velocity|
        from rest = D*omega/e over a distance D; target pumping can
        raise that ~1.6x — we budget 0.8*D*omega, a 2.2x margin) plus the
        LFO time modulation, whose waveform may step (square/S&H) but is
        bounded by +-MAX_LFO_TIME_MOD_MS."""
        from ..ops.smoothing import spring_omega
        d_max = float(self._max_offset(ctx))
        vmax = 0.8 * spring_omega(float(DELAY_TIME.smoothing_arg)) * d_max
        j_samp = 2.0 * MAX_LFO_TIME_MOD_MS * ctx.sample_rate / 1000.0
        span = 128.0 * (1.0 + vmax) + j_samp + 130.0
        return int(math.ceil(span / 128.0)) + 1

    def init_state(self, ctx: BuildCtx):
        dt = ctx.scan_dtype
        return {
            "line": chrono_ops.chrono_init(2, self._max_offset(ctx), dtype=dt),
            "svf": filters.tpt_state_init((2,), dtype=dt),
            "dc": filters.dc_state_init((2,), dtype=dt),
            "fb": jnp.zeros((2,), dt),
            "lfo": lfo_ops.lfo_init(),
        }

    def tail_frames(self, ctx: BuildCtx) -> int:
        """Analytic ring-out estimate (reference: delay.rs:455-474)."""
        delay_ms = self.delay_ms + MAX_LFO_TIME_MOD_MS
        delay_samples = delay_ms * ctx.sample_rate / 1000.0
        fb = abs(self.feedback)
        if self.drive > 0.0 or fb >= 0.9999:
            return int(10 * ctx.sample_rate)  # bounded stand-in for "unknown"
        if fb < 0.001:
            return int(math.ceil(delay_samples))
        decay = delay_samples + delay_samples * math.log10(0.001) / math.log10(fb)
        return max(int(math.ceil(decay)), 1)

    def max_tail_frames(self, ctx: BuildCtx) -> int:
        # FEEDBACK can be automated to 1.0 (and DRIVE above 0), which the
        # analytic estimate treats as "unknown" -> the bounded 10 s stand-in
        return int(10 * ctx.sample_rate)

    def process(self, state, x, params, ctx: BuildCtx):
        if ctx.channels != 2:
            raise ValueError("DelayEffect only supports stereo I/O")
        n = ctx.block_frames
        b = self._subblock(ctx)
        sr = ctx.sample_rate

        mode = params[MODE.id][0].astype(jnp.int32)
        ftype = params[FILTER_TYPE.id][0].astype(jnp.int32)
        shape = params[LFO_SHAPE.id][0].astype(jnp.int32)

        # LFO over the whole block with per-sample rate
        lfo_state, lfo_val = lfo_ops.lfo_block(
            state["lfo"], shape, params[LFO_RATE.id] / sr, n, seed=self.seed
        )

        delay_ms = jnp.maximum(
            params[DELAY_TIME.id] + lfo_val * params[LFO_TIME.id] * MAX_LFO_TIME_MOD_MS,
            1.0,
        )
        delay_samples = jnp.clip(
            delay_ms * 0.001 * sr, float(b + 1),
            (self.max_delay_capacity_ms + MAX_LFO_TIME_MOD_MS) * 0.001 * sr,
        )

        base_fb = params[FEEDBACK.id]
        feedback = jnp.clip(
            base_fb + lfo_val * params[LFO_FB.id] * (1.0 - jnp.abs(base_fb)), 0.0, 0.999
        )
        filter_mod = jnp.exp2(lfo_val * params[LFO_FILTER.id] * 2.0)
        cutoff = jnp.clip(params[FILTER_CUTOFF.id] * filter_mod, 20.0, sr / 2.0)
        drive = params[DRIVE.id]

        # per-sample SVF coefficients (a-side type-independent) + m-mix by type
        g = jnp.tan(math.pi * cutoff / sr)
        k = jnp.full_like(g, max(2.0 * (1.0 - FILTER_RESONANCE * 0.97), 0.03))
        a1 = 1.0 / (1.0 + g * (g + k))
        a2 = g * a1
        a3 = g * a2
        one = jnp.ones_like(g)
        zero = jnp.zeros_like(g)
        m_by_type = (
            (zero, zero, one),      # lowpass
            (one, -k, -one),        # highpass
            (zero, one, zero),      # bandpass
        )
        m0 = jnp.stack([m[0] for m in m_by_type])[ftype]
        m1 = jnp.stack([m[1] for m in m_by_type])[ftype]
        m2 = jnp.stack([m[2] for m in m_by_type])[ftype]

        dc_r = filters.dc_coefficient(sr, "default")
        is_pp = mode == 1

        H = chrono_ops.hist_len(self._max_offset(ctx))

        def sub_step(carry, idx):
            # rolling window carry [2, H] (chrono_ops.read_frac_win): the
            # whole-block [2, H+n] carry copied itself every scan step
            rw, svf, dc, fb_state = carry
            t0 = idx * b

            def sl(a):
                return jax.lax.dynamic_slice(a, (t0,), (b,))

            d_j = sl(delay_samples)
            fb_j = sl(feedback)
            drive_j = sl(drive)
            # grouped slab read: whole-window one-hots cost W-proportional
            # matmul time; the slab height is
            # the spring+LFO slew bound (_slab_rows)
            delayed = chrono_ops.read_frac_win_grouped(
                rw, d_j, self._slab_rows(ctx))  # [2, B]

            coefs = filters.TptCoefficients(
                sl(a1), sl(a2), sl(a3), sl(m0), sl(m1), sl(m2)
            )
            svf, filtered = filters.tpt_process(svf, delayed, coefs,
                                                dtype=ctx.scan_dtype)
            saturated = saturate(filtered, drive_j[None, :])
            dc, blocked = filters.dc_process(dc, saturated, dc_r,
                                             dtype=ctx.scan_dtype)
            clean = jnp.clip(blocked, -4.0, 4.0)  # [2, B]

            # previous-sample clean values (feedback source)
            prev = jnp.concatenate([fb_state[:, None], clean[:, :-1]], axis=-1)
            x_j = jax.lax.dynamic_slice(x, (jnp.zeros_like(t0), t0), (2, b))
            mono = (x_j[0] + x_j[1]) * 0.5
            # stereo: own-channel feedback; pingpong: cross-channel
            l_in = jnp.where(is_pp, mono + prev[1] * fb_j, x_j[0] + prev[0] * fb_j)
            r_in = jnp.where(is_pp, prev[0] * fb_j, x_j[1] + prev[1] * fb_j)
            rw = chrono_ops.roll(rw, jnp.stack([l_in, r_in]))

            return (rw, svf, dc, clean[:, -1]), clean

        carry0 = (state["line"].hist, state["svf"], state["dc"], state["fb"])
        (rw, svf, dc, fb_state), wets = jax.lax.scan(
            sub_step, carry0, jnp.arange(n // b, dtype=jnp.int32)
        )
        wet = jnp.moveaxis(wets, 0, 1).reshape(2, n).astype(x.dtype)

        wet_mix = params[WET.id]
        dry_gain = jnp.minimum((1.0 - wet_mix) * 2.0, 1.0)
        wet_gain = jnp.minimum(wet_mix * 2.0, 1.0)
        out = x * dry_gain[None, :] + wet * wet_gain[None, :]

        width = params[WIDTH.id]
        mid = (out[0] + out[1]) * 0.5
        side = (out[0] - out[1]) * 0.5
        y = jnp.stack([mid + side * width, mid - side * width])

        new_state = {"line": chrono_ops.Chrono(rw), "svf": svf, "dc": dc,
                     "fb": fb_state, "lfo": lfo_state}
        return new_state, y

    # DelayEffectMessage::Reset analog is handled by the engine via
    # reset_node() (state re-init); the Node default handle_message applies.
