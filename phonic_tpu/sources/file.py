"""Preloaded file playback source.

Behavioural spec: reference src/source/file.rs (FilePlaybackOptions :34-93),
src/source/file/preloaded.rs (loop/repeat/seek/stop semantics) and the
wrapper chain the player builds per played file —
Converted -> Amplified -> Panned (src/player.rs:540-559) — which is fused
here into one node: resample+remap, smoothed volume, smoothed constant-power
pan, fade-in/out.

Formulation: playback is *positional*.  The source carries its frame
position as an exact (int32 base, float32 frac) pair; a block computes
per-sample read positions analytically (cumsum of speed * rate_ratio), folds
them through the loop/repeat map with integer arithmetic, and gathers with
Hermite (default) or polyphase-sinc (high quality) interpolation — speed
ramps, loops and EOF are all vectorised gathers, zero per-sample control
flow.  For endless loops the carried position is re-folded every block so it
stays bounded (no precision decay over arbitrarily long renders).

Stop/kill arrive as per-block scalar inputs (global frame indices): the
fade-out gain is an analytic exponential starting at the stop frame
(reference de-clicks stops with a 50 ms VolumeFader, src/source/file.rs:106,
src/utils/fader.rs).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import jax.numpy as jnp

from ..graph.nodes import BuildCtx, Source
from ..io.decoder import AudioFileBuffer
from ..ops import resample as rs
from ..ops.buffer import remap_channels
from ..ops.convert import panning_factors
from ..ops.precision import ds_add
from ..params import DecibelScaling, FloatParameter, format_gain, format_pan

# int32-safe sentinel: single renders are limited to 2^31-1 frames (~12.4 h
# at 48 kHz) so the engine works without jax_enable_x64
NEVER = np.iinfo(np.int32).max


def _host_fade_log1m(duration_secs: float, sample_rate: int) -> float:
    """log(1 - inertia) of the de-click fader, as a static Python float
    (must not be staged: it parameterises analytic fade curves under jit)."""
    import math

    samples = sample_rate * duration_secs / math.log(100.0)
    return math.log1p(-(1.0 - math.exp(-1.0 / max(samples, 1e-9))))

VOLUME = FloatParameter(
    "VOLU", "Volume", 0.0, 4.0, 1.0, scaling=DecibelScaling(-60.0, 12.0),
    formatter=format_gain,
)
PANNING = FloatParameter("PANN", "Panning", -1.0, 1.0, 0.0, formatter=format_pan)
SPEED = FloatParameter("SPED", "Speed", 0.001, 16.0, 1.0, smoothing=None)


@dataclasses.dataclass
class FilePlaybackOptions:
    """reference: src/source/file.rs:34-93."""

    volume: float = 1.0
    panning: float = 0.0
    speed: float = 1.0
    repeat: Optional[int] = 0  # extra passes; None = forever
    loop_range: Optional[tuple[int, int]] = None  # overrides buffer's
    start_time: int = 0  # absolute output frame
    fade_in_secs: float = 0.0
    fade_out_secs: float = 0.05  # de-click stop fade (reference default 50 ms)
    resampling_quality: str = "default"  # "default" (hermite) | "high" (sinc)
    # seconds between Position status events (None = positions never emitted,
    # stop events still fire); reference default 1 s (src/source/file.rs:92-110)
    playback_pos_emit_rate: Optional[float] = 1.0
    # enable the per-source CPU-load probe readable via
    # PlaybackHandle.cpu_load() (reference: MeasuredSource, measured.rs)
    measure_cpu_load: bool = False

    def validate(self):
        """reference: FilePlaybackOptions::validate,
        src/source/file.rs:197-217."""
        from ..errors import ParameterError
        if not (self.volume >= 0.0):  # also catches NaN
            raise ParameterError(f"playback options 'volume' value is {self.volume!r}")
        if not (-1.0 <= self.panning <= 1.0):
            raise ParameterError(f"playback options 'panning' value is {self.panning!r}")
        if not (0.0 <= self.speed < float("inf")):
            raise ParameterError(f"playback options 'speed' value is {self.speed!r}")
        return self


class FileSource(Source):
    PARAMS = (VOLUME, PANNING, SPEED)
    WEIGHT = 1

    def __init__(
        self,
        buffer: AudioFileBuffer,
        options: Optional[FilePlaybackOptions] = None,
        name: Optional[str] = None,
    ):
        super().__init__(name)
        self.buffer = buffer
        self.options = (options or FilePlaybackOptions()).validate()
        self.loop_range = self.options.loop_range or buffer.loop_range
        self.loop_mode = buffer.loop_mode
        if self.options.resampling_quality not in ("default", "high"):
            raise ValueError(
                f"unknown resampling quality {self.options.resampling_quality!r}"
            )
        self._seeks: list[tuple[int, float]] = []  # (output frame, source frame)

    def seek(self, at_frame: int, to_source_frame: float):
        """Schedule a seek (reference: FilePlaybackMessage::Seek).  Like the
        reference — which drains playback messages once per write call
        (src/source/file/preloaded.rs) — seeks apply at block granularity:
        the block containing ``at_frame`` starts at the new position."""
        self._seeks.append((int(at_frame), float(to_source_frame)))

    def _max_speed_ever(self) -> float:
        """Upper bound on the SPED parameter over the program's lifetime so
        far: initial + every scheduled event value (glides/ramps interpolate
        between knots, so knots bound the trajectory)."""
        tl = getattr(self, "_timelines", {}).get(SPEED.id)
        vals = [self.options.speed]
        if tl is not None:
            vals.append(tl.initial)
            vals.extend(tl.values)
        return float(max(vals))

    def _speed_bucket(self, ctx_sr: Optional[int] = None) -> int:
        ratio = self.buffer.sample_rate / (ctx_sr or self.buffer.sample_rate)
        return rs.speed_bucket(self._max_speed_ever() * ratio)

    def lower_block_inputs(self, block_start: int, block_len: int):
        flag, pos = 0.0, 0.0
        for at, p in self._seeks:
            if block_start <= at < block_start + block_len:
                flag, pos = 1.0, p
        out = {"_seek_flag": np.float32(flag), "_seek_pos": np.float32(pos)}
        if self._uses_mm2():
            # speed bucket rides in this input's SHAPE: a set_speed above
            # the current bucket changes the packed-input structure, which
            # bumps the engine's _pack_version and retraces the step with
            # the wider read windows (one planned retrace per growth)
            # _ctx_sr is pinned by init_state; stacked lowering may run
            # before the first state build (e.g. precomputing a block
            # span), where the buffer-rate fallback gives the same bucket
            out["_spd_tag"] = np.zeros(
                (self._speed_bucket(getattr(self, "_ctx_sr", None)) + 1,),
                np.float32)
        return out

    def _uses_mm2(self) -> bool:
        return (self.options.resampling_quality != "high"
                and rs.use_mm2(self.buffer.frames))

    def param_initials(self):
        return {
            VOLUME.id: self.options.volume,
            PANNING.id: self.options.panning,
            SPEED.id: self.options.speed,
        }

    def _source_span(self) -> Optional[int]:
        """Total span in linear source frames, or None if endless."""
        frames = self.buffer.frames
        rpt = self.options.repeat
        if rpt is None:
            return None
        if self.loop_range is not None:
            start, end = self.loop_range
            return frames + rpt * (end - start)
        return frames * (rpt + 1)

    def duration_frames(self, ctx: BuildCtx) -> Optional[int]:
        span = self._source_span()
        if span is None:
            return None
        ratio = self.buffer.sample_rate / ctx.sample_rate
        return self.options.start_time + int(
            np.ceil(span / (ratio * max(self.options.speed, 1e-6)))
        )

    def init_state(self, ctx: BuildCtx):
        # position = base + frac + frac_lo; the (frac, frac_lo) pair is
        # compensated f32 so block-boundary rounding never accumulates.
        # The sample data rides in the state pytree (threaded unchanged):
        # passing it as an argument keeps it device-resident and out of
        # the compiled program.
        self._ctx_sr = ctx.sample_rate
        st = {
            "base": jnp.zeros((), jnp.int32),
            "frac": jnp.zeros((), jnp.float32),
            "frac_lo": jnp.zeros((), jnp.float32),
            # mm-packed for the gather-free two-stage one-hot read
            # (ops/resample.py hermite_read_mm2); the sinc path keeps the
            # planar layout for its windowed FIR, as do buffers long enough
            # that stage 1's HBM streaming loses to the gather (rs.use_mm2)
            "buf": (jnp.asarray(rs.mm_pack(np.asarray(self.buffer.data)))
                    if self._uses_mm2()
                    else jnp.asarray(self.buffer.data)),
        }
        if self.options.resampling_quality == "high":
            ratio = self.buffer.sample_rate / ctx.sample_rate
            st["sinc"] = jnp.asarray(rs.sinc_table(
                cutoff=min(1.0, 1.0 / max(ratio * self.options.speed, 1.0))))
        return st

    def _fold(self, ki, fr):
        """Linear source position (int frames ki + frac fr) -> buffer
        position + live mask (reference loop semantics:
        src/source/file/preloaded.rs:270-332)."""
        frames = self.buffer.frames
        rpt = self.options.repeat
        if self.loop_range is not None:
            start, end = int(self.loop_range[0]), int(self.loop_range[1])
            length = max(end - start, 1)
            rel = ki - start
            if self.loop_mode == "pingpong":
                c = jnp.mod(rel, 2 * length)
                fwd = c < length
                fki = jnp.where(fwd, start + c, start + 2 * length - c - 1)
                ffr = jnp.where(fwd, fr, 1.0 - fr)
            else:
                fki = start + jnp.mod(rel, length)
                ffr = fr
            in_loop = ki >= start
            if rpt is None:
                live = jnp.ones_like(ki, bool)
            else:
                span = start + (rpt + 1) * length
                after_ki = ki - rpt * length  # continue past loop to file end
                fki = jnp.where(ki < span, jnp.where(in_loop, fki, ki), after_ki)
                ffr = jnp.where(ki < span, jnp.where(in_loop, ffr, fr), fr)
                live = ki < frames + rpt * length
                return fki, ffr, live
            return jnp.where(in_loop, fki, ki), jnp.where(in_loop, ffr, fr), live
        if rpt is None:
            return jnp.mod(ki, frames), fr, jnp.ones_like(ki, bool)
        if rpt > 0:
            return jnp.mod(ki, frames), fr, ki < frames * (rpt + 1)
        return ki, fr, ki < frames

    def _fold_state(self, base):
        """Keep the carried position bounded for endless playback."""
        if self.options.repeat is not None:
            return base
        frames = self.buffer.frames
        if self.loop_range is not None:
            start, end = int(self.loop_range[0]), int(self.loop_range[1])
            length = max(end - start, 1)
            period = 2 * length if self.loop_mode == "pingpong" else length
            return jnp.where(base >= start, start + jnp.mod(base - start, period), base)
        return jnp.mod(base, frames)

    def process(self, state, x, params, ctx: BuildCtx):
        n = ctx.block_frames
        frame0 = params["_frame0"]  # i32/i64 scalar: global frame of block start
        stop_at = params.get("_stop_at", jnp.int32(NEVER))
        kill_at = params.get("_kill_at", jnp.int32(NEVER))
        gframes = frame0 + jnp.arange(n, dtype=frame0.dtype)

        ratio = self.buffer.sample_rate / ctx.sample_rate
        speed = params[SPEED.id]  # [n]
        active = (gframes >= self.options.start_time) & (gframes < kill_at)

        # scheduled seeks replace the carried position at block start
        seek_flag = params.get("_seek_flag", jnp.float32(0.0))
        seek_pos = params.get("_seek_pos", jnp.float32(0.0))
        seek_int = jnp.floor(seek_pos)
        base0 = jnp.where(seek_flag > 0.5, seek_int.astype(jnp.int32), state["base"])
        frac0 = jnp.where(seek_flag > 0.5, seek_pos - seek_int, state["frac"])
        frac_lo0 = jnp.where(seek_flag > 0.5, 0.0, state["frac_lo"])

        use_mm2 = self._uses_mm2()
        if use_mm2:
            # the read's two-stage windows are sized for steps <= smax
            # (2**bucket); the bucket tracks the max speed ever scheduled,
            # so this clamp never binds in-contract — it guarantees read
            # correctness if a bucket accounting bug ever under-sizes it
            smax = np.float32(2.0 ** (params["_spd_tag"].shape[0] - 1))
            speed = jnp.minimum(speed, smax / np.float32(ratio))
        steps = jnp.where(active, speed * np.float32(ratio), 0.0).astype(jnp.float32)
        # Positions as affine base + residual cumsum: exact (ulp-level) for
        # constant speed, and the residual is tiny during glides — a plain
        # f32 cumsum would drift by ~1e-2 frames across a block.
        s0 = steps[-1]
        resid = jnp.cumsum(steps - s0)
        rel = s0 * jnp.arange(n, dtype=jnp.float32) + jnp.concatenate(
            [jnp.zeros((1,), jnp.float32), resid[:-1]]
        )
        # fractional offset from base; frac_lo folds the compensated
        # sub-ulp remainder back in
        p = frac0 + (rel + frac_lo0)
        ip = jnp.floor(p)
        fr = p - ip
        ki = base0 + ip.astype(jnp.int32)

        fki, ffr, live = self._fold(ki, fr)
        mask = (active & live).astype(jnp.float32)

        buf = state["buf"]  # planar [ch, frames+1] (HQ) or mm-packed (default)
        pos = fki.astype(jnp.float32) + ffr
        if self.options.resampling_quality == "high":
            audio = rs.sinc_read(buf, pos, state["sinc"])
        elif use_mm2:
            # folded positions step by <= smax with mod-fold jumps — exactly
            # the mm2 contract (loops/pingpong/repeat wraps are exact)
            audio = rs.hermite_read_mm2(buf, pos, smax=float(smax))
        else:  # very long buffer: the O(n) gather wins (rs.use_mm2 cap)
            audio = rs.hermite_read(buf, pos)
        audio = audio * mask[None, :]
        audio = remap_channels(audio, ctx.channels)

        # volume + pan (reference wrapper chain Amplified -> Panned)
        gain = params[VOLUME.id] * self._fade_gains(gframes, stop_at, kill_at, ctx)
        audio = audio * gain[None, :]
        if ctx.channels >= 2:
            left, right = panning_factors(params[PANNING.id])
            audio = audio.at[0].multiply(left).at[1].multiply(right)

        advance = s0 * np.float32(n) + resid[-1]
        total, lo = ds_add(frac0, frac_lo0, advance)
        carry = jnp.floor(total)
        new_base = self._fold_state(base0 + carry.astype(jnp.int32))
        # subtracting the integer part is exact, so lo carries over unchanged
        new_state = {"base": new_base, "frac": total - carry, "frac_lo": lo,
                     "buf": buf}
        if "sinc" in state:
            new_state["sinc"] = state["sinc"]
        return new_state, audio

    def _fade_gains(self, gframes, stop_at, kill_at, ctx: BuildCtx):
        """Analytic fade-in from start_time and fade-out from stop_at
        (exponential fader semantics, src/utils/fader.rs:76-121)."""
        sr = ctx.sample_rate
        gain = jnp.ones(gframes.shape, jnp.float32)
        if self.options.fade_in_secs > 0.0:
            k = (gframes - self.options.start_time + 1).astype(jnp.float32)
            log1m = _host_fade_log1m(self.options.fade_in_secs, sr)
            up = 1.0 - jnp.exp(log1m * jnp.maximum(k, 0.0))
            gain = gain * jnp.where(k > 0, jnp.where(up > 1.0 - 1e-4, 1.0, up), 0.0)
        if self.options.fade_out_secs > 0.0:
            k = (gframes - stop_at + 1).astype(jnp.float32)
            log1m = _host_fade_log1m(self.options.fade_out_secs, sr)
            down = jnp.exp(log1m * jnp.maximum(k, 0.0))
            gain = gain * jnp.where(k > 0, jnp.where(down < 1e-4, 0.0, down), 1.0)
        else:
            gain = gain * (gframes < stop_at)
        return gain
