"""Stereo compressor / limiter with lookahead and soft knee.

Behavioural spec: reference src/effect/compressor.rs — ratio >= 20 switches
to limiter mode (slope 1, detector = peak over the whole lookahead window,
:239-260); soft-knee quadratic gain curve (:262-281); dB-domain
attack/release envelope follower; exponentially-smoothed makeup gain;
output = lookahead-delayed signal * gain.  Tail: lookahead + release.

Formulation: the lookahead delay is a static shift (carried [2, D]
tail); the limiter detector's "peak over the delay buffer" is an exact
sliding-window maximum via ``lax.reduce_window``; only the envelope
follower runs as a sequential scan (scalar state).  The lookahead TIME is
static per compiled program (the reference reallocates its delay line on
change too, compressor.rs:318-320); schedule-time changes are not supported.
"""

from __future__ import annotations

import math

import numpy as np
import jax
import jax.numpy as jnp

from ..graph.nodes import BuildCtx, Effect
from ..ops import follower as follower_ops
from ..ops.envelope import follower_alpha
from ..params import FloatParameter, format_db, format_ratio

THRESHOLD = FloatParameter("thrs", "Threshold", -60.0, 0.0, -12.0, unit="dB", smoothing=None)
RATIO = FloatParameter("rato", "Ratio", 1.0, 20.0, 8.0, formatter=format_ratio, smoothing=None)
KNEE = FloatParameter("knee", "Knee", 0.0, 12.0, 3.0, smoothing=None)
ATTACK = FloatParameter("attk", "Attack", 0.001, 0.5, 0.02, unit="s", smoothing=None)
RELEASE = FloatParameter("rels", "Release", 0.1, 2.0, 2.0, unit="s", smoothing=None)
MAKEUP = FloatParameter("gain", "Makeup Gain", -24.0, 24.0, 6.0, unit="dB")
LOOKAHEAD = FloatParameter("look", "Lookahead", 0.001, 0.2, 0.04, unit="s", smoothing=None)

_LN10_20 = 20.0 / math.log(10.0)
DEFAULT_LIMITER_THRESHOLD = -0.01


def _sliding_window_max(x, w: int):
    """Exact sliding-window maximum (van Herk / Gil-Werman): two cummax
    passes instead of ``lax.reduce_window`` (whose stride-1 lowering is
    slow to compile for windows this wide).

    Returns y with y[k] = max(x[k .. k+w-1]) for k in [0, len(x) - w].
    """
    n = x.shape[-1]
    n_out = n - w + 1
    pad = (-n) % w
    xp = jnp.pad(x, (0, pad), constant_values=-jnp.inf)
    chunks = xp.reshape(-1, w)
    prefix = jax.lax.cummax(chunks, axis=1).reshape(-1)  # max(chunk_start..i)
    suffix = jax.lax.cummax(chunks[:, ::-1], axis=1)[:, ::-1].reshape(-1)
    # window [k, k+w-1] spans at most two chunks: suffix covers k..chunk_end,
    # prefix covers chunk_start..k+w-1
    return jnp.maximum(suffix[:n_out], prefix[w - 1 : w - 1 + n_out])


class CompressorEffect(Effect):
    PARAMS = (THRESHOLD, RATIO, KNEE, ATTACK, RELEASE, MAKEUP, LOOKAHEAD)
    WEIGHT = 4

    def __init__(self, threshold: float = -12.0, ratio: float = 8.0,
                 knee: float = 3.0, attack: float = 0.02, release: float = 2.0,
                 makeup_gain: float = 6.0, lookahead: float = 0.04, name=None):
        super().__init__(name)
        self.threshold = float(threshold)
        self.ratio = float(ratio)
        self.knee = float(knee)
        self.attack = float(attack)
        self.release = float(release)
        self.makeup_gain = float(makeup_gain)
        self.lookahead = float(lookahead)

    @classmethod
    def limiter(cls, threshold: float = DEFAULT_LIMITER_THRESHOLD,
                attack: float = 0.02, release: float = 2.0, name=None):
        """Limiter preset: ratio 20, hard knee, no makeup, lookahead = attack
        (reference: compressor.rs:112-156)."""
        return cls(threshold=threshold, ratio=20.0, knee=0.0, attack=attack,
                   release=release, makeup_gain=0.0, lookahead=attack, name=name)

    def param_initials(self):
        return {
            THRESHOLD.id: self.threshold, RATIO.id: self.ratio, KNEE.id: self.knee,
            ATTACK.id: self.attack, RELEASE.id: self.release,
            MAKEUP.id: self.makeup_gain, LOOKAHEAD.id: self.lookahead,
        }

    def _delay_frames(self, ctx: BuildCtx) -> int:
        return int(math.ceil(self.lookahead * ctx.sample_rate))

    def batch_key(self, ctx: BuildCtx):
        # lookahead sets the delay-line length used while tracing
        return (type(self).__name__, self._delay_frames(ctx))

    def init_state(self, ctx: BuildCtx):
        d = self._delay_frames(ctx)
        return {
            # last D input frames (delay memory) and the matching |peak| tail
            "tail": jnp.zeros((ctx.channels, d), jnp.float32),
            "env": jnp.asarray(-120.0 if self.ratio >= 20.0 else 0.0,
                               ctx.scan_dtype),
        }

    def tail_frames(self, ctx: BuildCtx) -> int:
        return self._delay_frames(ctx) + int(math.ceil(self.release * ctx.sample_rate))

    def max_tail_frames(self, ctx: BuildCtx) -> int:
        # RELEASE is automatable up to its range max (the lookahead delay
        # line length is fixed at construction)
        return self._delay_frames(ctx) + int(math.ceil(RELEASE.max * ctx.sample_rate))

    def process(self, state, x, params, ctx: BuildCtx):
        if ctx.channels != 2:
            raise ValueError("CompressorEffect only supports stereo I/O")
        n = ctx.block_frames
        d = self._delay_frames(ctx)
        sr = ctx.sample_rate

        threshold = params[THRESHOLD.id]
        ratio = params[RATIO.id]
        knee = params[KNEE.id]
        attack_a = follower_alpha(params[ATTACK.id], sr, dtype=ctx.scan_dtype)
        release_a = follower_alpha(params[RELEASE.id], sr, dtype=ctx.scan_dtype)
        makeup = params[MAKEUP.id]

        ext = jnp.concatenate([state["tail"], x], axis=-1)  # [2, D + n]
        # delayed[i] = input[i - d] (tail holds the previous D input frames)
        delayed = ext[:, :n] if d > 0 else x

        frame_peak = jnp.maximum(jnp.abs(x[0]), jnp.abs(x[1]))
        # limiter detector: exact sliding max over the last D frames incl. current
        ext_peak = jnp.maximum(jnp.abs(ext[0]), jnp.abs(ext[1]))
        if d > 0:
            win = _sliding_window_max(ext_peak, d)  # win[k] = max(ext[k..k+d-1])
            lookahead_peak = win[-n:]
        else:
            lookahead_peak = frame_peak

        is_limiter = ratio >= 20.0
        det_peak = jnp.where(is_limiter, lookahead_peak, frame_peak).astype(
            ctx.scan_dtype)
        input_db = jnp.where(
            det_peak > 1e-6, _LN10_20 * jnp.log(jnp.maximum(det_peak, 1e-7)), -120.0
        )

        bc = lambda v: jnp.broadcast_to(v, (n,)).astype(ctx.scan_dtype)
        env_end, envelope = follower_ops.asym_follower(
            bc(input_db), bc(attack_a), bc(release_a), state["env"])

        slope = jnp.where(is_limiter, 1.0, 1.0 - 1.0 / jnp.maximum(ratio, 1.0))
        t = threshold
        w = knee
        lower = t - w / 2.0
        upper = t + w / 2.0
        xk = (envelope - lower) / jnp.maximum(w, 1e-9)
        in_knee = (w > 0.0) & (envelope > lower) & (envelope < upper)
        gr_db = jnp.where(
            in_knee,
            xk * xk * slope * w / 2.0,
            jnp.where(envelope > upper, (envelope - t) * slope, 0.0),
        )

        total_db = makeup - gr_db
        gain = jnp.where(total_db == 0.0, 1.0,
                         jnp.exp(total_db / _LN10_20)).astype(x.dtype)
        y = delayed * gain[None, :]

        new_tail = ext[:, -d:] if d > 0 else state["tail"]
        return {"tail": new_tail, "env": env_end}, y
