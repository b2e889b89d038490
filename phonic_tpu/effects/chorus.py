"""Stereo chorus with LFO-modulated delay lines and filtered input.

Behavioural spec: reference src/effect/chorus.rs — two sine-LFO-modulated
interpolated delay lines (right LFO phase-offset by PHASE radians), feedback
written into the line (write = filtered_input + delayed * feedback), an SVF
pre-filter on the input, dry/wet output mix (:311-385).  Modulation range is
256 samples scaled by sample rate (:330-333); read position =
2 + delay + (1 + lfo) * depth_samples.

Formulation: the input SVF runs as one parallel scan over the whole
block (it is outside the feedback loop); the feedback loop itself is a
sub-block scan whose body is only a fractional ring read + contiguous write
(see ops/ring.py).  Runtime read positions are clamped to >= B+1 samples;
construct with a smaller ``min_delay_ms`` for near-flanger settings.
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

MAX_RANGE_SAMPLES = 256.0  # at 44.1 kHz (chorus.rs:139)
MAX_DELAY_MS = 100.0

RATE = FloatParameter("rate", "Rate", 0.01, 10.0, 1.0, unit="Hz",
                      scaling=ExponentialScaling(2.0))
PHASE = FloatParameter("phas", "Phase", 0.0, math.pi, math.pi / 2.0,
                       formatter=format_degrees)
DEPTH = FloatParameter("dpth", "Depth", 0.0, 1.0, 0.25, formatter=format_percent)
FEEDBACK = FloatParameter("fdbk", "Feedback", -1.0, 1.0, 0.5, formatter=format_percent)
DELAY = FloatParameter("dlay", "Delay", 0.0, MAX_DELAY_MS, 12.0, unit="ms")
WET = FloatParameter("wet_", "Wet", 0.0, 1.0, 0.5, formatter=format_percent)
FILTER_TYPE = EnumParameter("fltt", "Filter Type", ("Lowpass", "Highpass", "Bandpass"), "Lowpass")
FILTER_FREQ = FloatParameter("fltf", "Filter Freq", 20.0, 20000.0, 20000.0,
                             unit="Hz", scaling=ExponentialScaling(2.5))
FILTER_RES = FloatParameter("fltq", "Filter Resonance", 0.0, 1.0, 0.0)


class ChorusEffect(Effect):
    PARAMS = (RATE, PHASE, DEPTH, FEEDBACK, DELAY, WET, FILTER_TYPE,
              FILTER_FREQ, FILTER_RES)
    WEIGHT = 3

    def __init__(self, rate: float = 1.0, phase: float = math.pi / 2.0,
                 depth: float = 0.25, feedback: float = 0.5, delay_ms: float = 12.0,
                 wet: float = 0.5, filter_type: str = "Lowpass",
                 filter_freq: float = 20000.0, filter_resonance: float = 0.0,
                 min_delay_ms: float = None, name=None):
        super().__init__(name)
        self.rate = float(rate)
        self.phase = float(phase)
        self.depth = float(depth)
        self.feedback = float(feedback)
        self.delay_ms = float(delay_ms)
        self.wet = float(wet)
        self.filter_type = filter_type
        self.filter_freq = float(filter_freq)
        self.filter_resonance = float(filter_resonance)
        # smallest modulated read position the compiled program must support
        self.min_delay_ms = float(min_delay_ms if min_delay_ms is not None else delay_ms)

    def param_initials(self):
        return {
            RATE.id: self.rate, PHASE.id: self.phase, DEPTH.id: self.depth,
            FEEDBACK.id: self.feedback, DELAY.id: self.delay_ms, WET.id: self.wet,
            FILTER_TYPE.id: FILTER_TYPE.index_of(self.filter_type),
            FILTER_FREQ.id: self.filter_freq, FILTER_RES.id: self.filter_resonance,
        }

    def _subblock(self, ctx: BuildCtx) -> int:
        min_pos = 2.0 + self.min_delay_ms * ctx.sample_rate / 1000.0
        return ring_ops.pick_subblock(min_pos, ctx.block_frames, cap=512)

    def batch_key(self, ctx: BuildCtx):
        # sub-block size is baked into the trace
        return (type(self).__name__, self._subblock(ctx))

    def _max_offset(self, ctx: BuildCtx) -> int:
        lfo_range = MAX_RANGE_SAMPLES * ctx.sample_rate / 44100.0
        return (2 + int(math.ceil(MAX_DELAY_MS * ctx.sample_rate / 1000.0))
                + 2 * int(math.ceil(lfo_range)) + 2)

    def init_state(self, ctx: BuildCtx):
        dt = ctx.scan_dtype
        return {
            "line": chrono_ops.chrono_init(2, self._max_offset(ctx), dtype=dt),
            "svf": filters.tpt_state_init((2,), dtype=dt),
            "lfo_l": lfo_ops.lfo_init(0.0),
            "lfo_r": lfo_ops.lfo_init(0.0),  # phase offset applied per block
        }

    def tail_frames(self, ctx: BuildCtx) -> int:
        """reference: chorus.rs:400-420."""
        sr = ctx.sample_rate
        depth_ms = MAX_RANGE_SAMPLES * 1000.0 / sr
        total_ms = self.delay_ms + depth_ms
        fb = abs(self.feedback)
        if fb >= 1.0:
            return int(10 * sr)
        if fb < 0.001:
            return int(math.ceil(total_ms * sr / 1000.0))
        total = total_ms * sr / 1000.0
        return max(int(math.ceil(total + total * math.log10(0.001) / math.log10(fb))), 1)

    def max_tail_frames(self, ctx: BuildCtx) -> int:
        # FEEDBACK is automatable to +-1.0 -> the "unknown tail" 10 s cap
        return int(10 * ctx.sample_rate)

    def process(self, state, x, params, ctx: BuildCtx):
        if ctx.channels != 2:
            raise ValueError("ChorusEffect only supports stereo I/O")
        n = ctx.block_frames
        b = self._subblock(ctx)
        sr = ctx.sample_rate
        lfo_range = MAX_RANGE_SAMPLES * sr / 44100.0

        # input pre-filter (outside the feedback loop): whole-block scan
        ftype = params[FILTER_TYPE.id][0].astype(jnp.int32)
        cutoff = jnp.clip(params[FILTER_FREQ.id], 20.0, sr / 2.0)
        res = params[FILTER_RES.id]
        g = jnp.tan(math.pi * cutoff / sr)
        k = jnp.maximum(2.0 * (1.0 - res * 0.97), 0.03)
        a1 = 1.0 / (1.0 + g * (g + k))
        one = jnp.ones_like(g)
        zero = jnp.zeros_like(g)
        m = (
            (zero, zero, one), (one, -k, -one), (zero, one, zero),
        )
        coefs = filters.TptCoefficients(
            a1, g * a1, g * g * a1,
            jnp.stack([t[0] for t in m])[ftype],
            jnp.stack([t[1] for t in m])[ftype],
            jnp.stack([t[2] for t in m])[ftype],
        )
        svf, filtered = filters.tpt_process(state["svf"], x, coefs,
                                            dtype=ctx.scan_dtype)

        # LFOs: sine pair with a phase offset on the right channel
        inc = params[RATE.id] / sr
        phase_norm = params[PHASE.id] / (2.0 * math.pi)
        lfo_l_state, lfo_l = lfo_ops.lfo_block(state["lfo_l"], lfo_ops.SINE, inc, n)
        # right LFO = left phase + offset; evaluate from the same accumulator
        shifted = lfo_ops.LfoState(
            phase=jnp.mod(state["lfo_l"].phase + phase_norm[0], 1.0),
            wraps=state["lfo_l"].wraps,
        )
        _, lfo_r = lfo_ops.lfo_block(shifted, lfo_ops.SINE, inc, n)

        H = chrono_ops.hist_len(self._max_offset(ctx))
        delay_samples = params[DELAY.id] * 0.001 * sr
        depth_samples = lfo_range * params[DEPTH.id]
        pos_l = jnp.clip(2.0 + delay_samples + (1.0 + lfo_l) * depth_samples,
                         float(b + 1), float(H - 2))
        pos_r = jnp.clip(2.0 + delay_samples + (1.0 + lfo_r) * depth_samples,
                         float(b + 1), float(H - 2))
        feedback = jnp.clip(params[FEEDBACK.id], -0.999, 0.999)

        def sub_step(rw, idx):
            # rolling window carry [2, H] (chrono_ops.read_frac_win): the
            # whole-block [2, H+n] carry copied itself every scan step
            t0 = idx * b

            def sl(a):
                return jax.lax.dynamic_slice(a, (t0,), (b,))

            # read offsets are per-output-sample delays (the window read
            # advances by j internally)
            offs = jnp.stack([sl(pos_l), sl(pos_r)])
            d = chrono_ops.read_frac_win(rw, offs)  # [2, B]
            fb_j = sl(feedback)
            fl = jax.lax.dynamic_slice(filtered, (jnp.zeros_like(t0), t0), (2, b))
            rw = chrono_ops.roll(rw, fl + d * fb_j[None, :])
            return rw, d

        rw, wets = jax.lax.scan(
            sub_step, state["line"].hist, jnp.arange(n // b, dtype=jnp.int32),
        )
        wet = jnp.moveaxis(wets, 0, 1).reshape(2, n).astype(x.dtype)

        wet_mix = params[WET.id]
        y = x * (1.0 - wet_mix)[None, :] + wet * wet_mix[None, :]

        new_state = {
            "line": chrono_ops.Chrono(rw), "svf": svf,
            "lfo_l": lfo_l_state, "lfo_r": state["lfo_r"],
        }
        return new_state, y
