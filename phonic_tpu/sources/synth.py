"""One-shot synth tone source + the SynthDef voice protocol.

Behavioural spec: reference src/source/synth.rs (SynthPlaybackOptions
:27-61, stop message), src/source/synth/common.rs (generator trait + fades
and status handling) and src/source/synth/fundsp.rs (FunDSP-unit-driven
source that auto-exhausts after 2 s below -60 dB).

The analog of a FunDSP AudioUnit is a **SynthDef**: a pure-function
voice with an explicit state pytree:

    init(ctx)                                  -> state
    render(state, SynthContext) -> (state, audio)   # mono [n] or [ch, n]

SynthContext carries per-sample gate / frequency / age arrays so envelopes
and glides are vectorised.  Ship your own DSP inside ``render`` with any
jnp/ops primitives; see phonic_tpu.synths for dx7/organ/sub3 examples.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from ..graph.nodes import BuildCtx, Source
from ..ops.buffer import remap_channels
from ..ops.convert import panning_factors
from ..params import DecibelScaling, FloatParameter, format_gain, format_pan

NEVER = np.iinfo(np.int32).max

VOLUME = FloatParameter("VOLU", "Volume", 0.0, 4.0, 1.0,
                        scaling=DecibelScaling(-60.0, 12.0), formatter=format_gain)
PANNING = FloatParameter("PANN", "Panning", -1.0, 1.0, 0.0, formatter=format_pan)


class SynthContext(NamedTuple):
    """Per-block voice context handed to SynthDef.render."""

    freq: jnp.ndarray  # f32[n] Hz
    gate: jnp.ndarray  # f32[n] 1 while held, 0 after release
    velocity: jnp.ndarray  # f32 scalar (or [n])
    age: jnp.ndarray  # i32[n] samples since note start (may be negative)
    release_age: jnp.ndarray  # f32 scalar/[n]: age at note-off (inf = held)
    sample_rate: int
    block_frames: int
    # user-declared FourCC parameters (SynthDef.params): engine-smoothed
    # per-sample [n] arrays (reference: fundsp Shared vars per voice,
    # src/generator/fundsp/parameter.rs:1-123)
    params: dict = {}
    # per-voice modulation matrix outputs per target parameter id, [n] in
    # the matrix's output range — combine them in render however the synth
    # wants, like the reference's var_buffer(shared_buffer) nodes
    # (src/generator/fundsp/modulation.rs:159-220)
    mods: dict = {}


@dataclasses.dataclass
class SynthDef:
    """A pure-function synth voice (the FunDSP AudioUnit analog).

    ``params`` declares user FourCC parameters (reference: the FunDSP
    generator's shared parameters, src/generator/fundsp.rs:88-99): they
    become engine-smoothed per-block arrays in ``SynthContext.params``,
    settable at runtime via ``GeneratorPlaybackHandle.set_parameter`` and
    routable as modulation targets (SynthGenerator.with_modulation)."""

    init: Callable[[BuildCtx], dict]
    render: Callable[[dict, SynthContext], tuple]
    channels: int = 1
    params: tuple = ()


@dataclasses.dataclass
class SynthPlaybackOptions:
    """reference: src/source/synth.rs:27-75."""

    volume: float = 1.0
    panning: float = 0.0
    start_time: int = 0
    duration: Optional[int] = None  # output frames of gate-on; None = until stop
    fade_in_secs: float = 0.0
    fade_out_secs: float = 0.05
    frequency: float = 440.0
    velocity: float = 1.0
    # seconds between Position status events (None = positions never
    # emitted); reference default 1 s (src/source/synth.rs:46-51)
    playback_pos_emit_rate: Optional[float] = 1.0
    # enable the per-source CPU-load probe (src/source/synth.rs:58-61)
    measure_cpu_load: bool = False

    def validate(self):
        """reference: SynthPlaybackOptions::validate, synth.rs:128-143."""
        from ..errors import ParameterError
        if not (self.volume >= 0.0):  # also catches NaN
            raise ParameterError(f"playback options 'volume' value is {self.volume!r}")
        if not (-1.0 <= self.panning <= 1.0):
            raise ParameterError(f"playback options 'panning' value is {self.panning!r}")
        return self


class SynthSource(Source):
    """Plays one SynthDef voice as a plain source (play_synth path)."""

    PARAMS = (VOLUME, PANNING)
    WEIGHT = 2

    def __init__(self, synth: SynthDef, options: Optional[SynthPlaybackOptions] = None,
                 name=None):
        super().__init__(name)
        self.synth = synth
        self.options = (options or SynthPlaybackOptions()).validate()
        # user-declared FourCC parameters become engine-smoothed inputs
        self.PARAMS = SynthSource.PARAMS + tuple(synth.params)

    def param_initials(self):
        out = {VOLUME.id: self.options.volume, PANNING.id: self.options.panning}
        for p in self.synth.params:
            out[p.id] = p.default
        return out

    # adopt() carries the synth's own state pytree across topology rebuilds
    # when this source renders as a batched lane (graph/batching.LeafBatch)
    BATCH_CARRY = ("synth",)

    def source_batch_key(self, ctx):
        """Homogeneous SynthSources (the SAME SynthDef object, so identical
        render traces) render as one vmapped lane bank; per-lane start/
        duration/frequency/velocity ride in as traced statics."""
        if type(self) is not SynthSource:
            return None
        return ("synth", id(self.synth),
                round(self.options.fade_in_secs, 9),
                round(self.options.fade_out_secs, 9))

    def source_batch_statics(self, ctx):
        opt = self.options
        return {
            "_start_t0": np.int32(opt.start_time),
            "_gate_dur": np.int32(NEVER if opt.duration is None
                                  else opt.duration),
            "_freq0": np.float32(opt.frequency),
            "_vel0": np.float32(opt.velocity),
        }

    def init_state(self, ctx: BuildCtx):
        return {"synth": self.synth.init(ctx)}

    def duration_frames(self, ctx: BuildCtx) -> Optional[int]:
        if self.options.duration is None:
            return None
        fade = int(self.options.fade_out_secs * ctx.sample_rate) + 1
        return self.options.start_time + self.options.duration + fade

    def process(self, state, x, params, ctx: BuildCtx):
        n = ctx.block_frames
        frame0 = params["_frame0"]
        stop_at = params.get("_stop_at", jnp.int32(NEVER))
        gframes = frame0 + jnp.arange(n, dtype=jnp.int32)

        opt = self.options
        # per-lane statics arrive traced when this source renders as a
        # batched lane (LeafBatch); the unbatched path uses the same names
        # with compile-time constants, tracing the identical program
        start_t = params.get("_start_t0", jnp.int32(opt.start_time))
        dur = params.get("_gate_dur", jnp.int32(
            NEVER if opt.duration is None else opt.duration))
        age = gframes - start_t
        # (start_t + dur may wrap int32 when dur is the NEVER sentinel; the
        # where() discards that branch)
        gate_end = jnp.minimum(
            jnp.where(dur >= NEVER, jnp.int32(NEVER), start_t + dur),
            stop_at,
        )
        gate = ((gframes >= start_t) & (gframes < gate_end)).astype(jnp.float32)

        sctx = SynthContext(
            freq=jnp.full((n,), jnp.float32(1.0))
            * params.get("_freq0", jnp.float32(opt.frequency)),
            gate=gate,
            velocity=params.get("_vel0", jnp.float32(opt.velocity)),
            age=age,
            release_age=(gate_end - start_t).astype(jnp.float32),
            sample_rate=ctx.sample_rate,
            block_frames=n,
            params={p.id: params[p.id] for p in self.synth.params},
        )
        synth_state, audio = self.synth.render(state["synth"], sctx)
        if audio.ndim == 1:
            audio = audio[None, :]
        audio = remap_channels(audio, ctx.channels)
        audio = audio * (age >= 0).astype(jnp.float32)[None, :]

        # analytic exponential fade-in from start (synth.rs:41-44 fade_in
        # option; exponential fader semantics, src/utils/fader.rs:76-121)
        if opt.fade_in_secs > 0.0:
            from .file import _host_fade_log1m

            k_in = (age + 1).astype(jnp.float32)
            log1m_in = _host_fade_log1m(opt.fade_in_secs, ctx.sample_rate)
            up = 1.0 - jnp.exp(log1m_in * jnp.maximum(k_in, 0.0))
            audio = audio * jnp.where(
                k_in > 0, jnp.where(up > 1.0 - 1e-4, 1.0, up), 0.0)[None, :]

        # de-click fade after the gate closes (the SynthDef's own envelope
        # normally handles the decay; this guards non-enveloped defs)
        k = (gframes - gate_end + 1).astype(jnp.float32)
        log1m = math.log1p(-(1.0 - math.exp(
            -1.0 / max(ctx.sample_rate * opt.fade_out_secs / math.log(100.0), 1e-9)
        )))
        down = jnp.exp(log1m * jnp.maximum(k, 0.0))
        audio = audio * jnp.where(k > 0, jnp.where(down < 1e-4, 0.0, down), 1.0)[None, :]

        gain = params[VOLUME.id]
        audio = audio * gain[None, :]
        if ctx.channels >= 2:
            left, right = panning_factors(params[PANNING.id])
            audio = audio.at[0].multiply(left).at[1].multiply(right)
        return {"synth": synth_state}, audio
