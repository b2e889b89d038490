"""Polyphonic sample-playback generator (the reference's flagship instrument).

Behavioural spec: reference src/generator/sampler.rs + sampler/voice.rs —
per-voice chain Panned<Amplified<ChannelMapped<PreloadedFileSource>>> with
AHDSR envelope; effective speed = speed_from_note(note) *
2^(transpose/12 + finetune/1200) (voice.rs:144-157); effective volume =
base * note velocity, panning = clamp(base + note) (voice.rs:158-161);
envelope triggered at full volume (velocity scales the amplifier);
voice stealing free -> longest-releasing -> oldest (sampler.rs:826-860);
FourCC parameters STRN/SFTN/SVOL/SPAN + AHDSR AENV/AHLD/ADEC/ASUS/AREL.

Formulation: the host-side allocator replays the reference's steal
policy over the scheduled note timeline and lowers each block into per-voice
tensors: one *continuing* note descriptor plus at most one *retrigger*
(steal) descriptor.  The voice bank renders as two masked lanes under vmap —
sample positions are analytic cumsums, envelopes are the closed-form AHDSR —
so a steal mid-block is exact: the old note's tail renders up to the
trigger, the new note from it.

Known deviations: AHDSR parameter changes re-shape the envelope of already
sounding notes analytically (the reference mutates rates mid-trajectory);
more than one steal of the same voice within one block keeps only the last
note (raise EngineConfig.block alignment or voice count if that triggers).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..graph.nodes import BuildCtx
from ..io.decoder import AudioFileBuffer
from ..ops import ahdsr as ahdsr_ops
from ..ops import resample as rs
from ..events import ParamTimeline
from ..ops.convert import panning_factors
from ..ops.smoothing import SegmentEvents, step_targets
from ..params import DecibelScaling, ExponentialScaling, FloatParameter, IntegerParameter, format_gain, format_pan
from .base import Generator, GeneratorPlaybackOptions
from .granular import (
    DIRECTIONS, GranularConfig, OVERLAP_MODES, POOL_SIZE, WINDOW_MODES,
    grain_state_init, granular_voice_block,
)
from ..modulation.matrix import (
    ModulationRoutings, apply_matrix, build_source_specs, eval_sources,
    source_polarity,
)
from ..params import EnumParameter

NEVER = np.iinfo(np.int32).max

# granular renders in sub-chunks of this size when block_frames exceeds it
# (the grain pool allocates-then-renders per chunk; see _process_granular)
_GRANULAR_CHUNK = 2048

TRANSPOSE = IntegerParameter("STRN", "Transpose", -48, 48, 0, unit="st")
FINETUNE = IntegerParameter("SFTN", "Finetune", -100, 100, 0, unit="ct")
VOLUME = FloatParameter("SVOL", "Volume", 1e-6, 15.848932, 1.0,
                        scaling=DecibelScaling(-60.0, 24.0), formatter=format_gain)
PANNING = FloatParameter("SPAN", "Panning", -1.0, 1.0, 0.0, formatter=format_pan)

# envelope parameters, 0..10 s exponentially scaled (sampler.rs:130-181)
ENV_ATTACK = FloatParameter("AATK", "Attack", 0.0, 10.0, 0.01, unit="s",
                            scaling=ExponentialScaling(3.0), smoothing=None)
ENV_HOLD = FloatParameter("AHLD", "Hold", 0.0, 10.0, 0.0, unit="s",
                          scaling=ExponentialScaling(3.0), smoothing=None)
ENV_DECAY = FloatParameter("ADCY", "Decay", 0.0, 10.0, 0.0, unit="s",
                           scaling=ExponentialScaling(3.0), smoothing=None)
ENV_SUSTAIN = FloatParameter("ASTN", "Sustain", 0.0, 1.0, 1.0, smoothing=None)
ENV_RELEASE = FloatParameter("AREL", "Release", 0.0, 10.0, 0.05, unit="s",
                             scaling=ExponentialScaling(3.0), smoothing=None)

# granular parameters (sampler.rs:219-296)
GRAIN_OVERLAP = EnumParameter("GOVM", "Overlap Mode", OVERLAP_MODES, "Cloud")
GRAIN_WINDOW = EnumParameter("GWND", "Window", WINDOW_MODES, "Hann")
GRAIN_SIZE = FloatParameter("GSIZ", "Grain Size", 1.0, 1000.0, 100.0, unit="ms",
                            scaling=ExponentialScaling(2.0), smoothing=None)
GRAIN_DENSITY = FloatParameter("GDEN", "Density", 1.0, 100.0, 10.0, unit="Hz",
                               scaling=ExponentialScaling(2.0), smoothing=None)
GRAIN_VARIATION = FloatParameter("GVAR", "Variation", 0.0, 1.0, 0.0, smoothing=None)
GRAIN_SPRAY = FloatParameter("GSPY", "Spray", 0.0, 1.0, 0.0, smoothing=None)
GRAIN_PAN_SPREAD = FloatParameter("GPAN", "Pan Spread", 0.0, 1.0, 0.0, smoothing=None)
GRAIN_DIRECTION = EnumParameter("GDIR", "Direction", DIRECTIONS, "Forward")
GRAIN_POSITION = FloatParameter("GPOS", "Position", 0.0, 1.0, 0.5, smoothing=None)
GRAIN_STEP = FloatParameter("GSTP", "Step", -4.0, 4.0, 0.0, unit="x", smoothing=None)
LFO1_RATE = FloatParameter("ML1R", "LFO 1 Rate", 0.01, 20.0, 1.0, unit="Hz", smoothing=None)
LFO1_WAVE = EnumParameter("ML1W", "LFO 1 Waveform",
                          ("Sine", "Triangle", "Ramp Up", "Ramp Down", "Square",
                           "Random", "Smooth Random"), "Sine")
LFO2_RATE = FloatParameter("ML2R", "LFO 2 Rate", 0.01, 20.0, 2.0, unit="Hz", smoothing=None)
LFO2_WAVE = EnumParameter("ML2W", "LFO 2 Waveform",
                          ("Sine", "Triangle", "Ramp Up", "Ramp Down", "Square",
                           "Random", "Smooth Random"), "Sine")

GRANULAR_PARAMS = (GRAIN_OVERLAP, GRAIN_WINDOW, GRAIN_SIZE, GRAIN_DENSITY,
                   GRAIN_VARIATION, GRAIN_SPRAY, GRAIN_PAN_SPREAD,
                   GRAIN_DIRECTION, GRAIN_POSITION, GRAIN_STEP,
                   LFO1_RATE, LFO1_WAVE, LFO2_RATE, LFO2_WAVE)


@dataclasses.dataclass
class AhdsrConfig:
    attack: float = 0.01
    hold: float = 0.0
    decay: float = 0.0
    sustain: float = 1.0
    release: float = 0.05


@dataclasses.dataclass
class _Segment:
    start: int
    note: int
    note_id: int
    volume: float
    panning: float
    release: float = math.inf  # absolute frame of note-off
    cut: float = math.inf  # absolute frame where a steal hard-cuts the voice
    # per-note automation (reference: GeneratorPlaybackEvent::SetVolume /
    # SetPanning / SetSpeed, voice.rs:238-300); created lazily on first event
    vol_tl: object = None
    pan_tl: object = None
    spd_tl: object = None

    def speed0(self) -> float:
        """Note-derived speed multiplier before automation."""
        return 2.0 ** ((self.note - 60) / 12.0)


class Sampler(Generator):
    PARAMS = (TRANSPOSE, FINETUNE, VOLUME, PANNING,
              ENV_ATTACK, ENV_HOLD, ENV_DECAY, ENV_SUSTAIN, ENV_RELEASE)

    def __init__(
        self,
        buffer: AudioFileBuffer,
        options: Optional[GeneratorPlaybackOptions] = None,
        envelope: Optional[AhdsrConfig] = None,
        transpose: int = 0,
        finetune: int = 0,
        name=None,
    ):
        super().__init__(options, name)
        self.buffer = buffer
        self.envelope = envelope
        self.transpose = int(transpose)
        self.finetune = int(finetune)
        self.granular: Optional[GranularConfig] = None
        self.modulation = ModulationRoutings()
        self.mod_config = self.modulation.config
        self.seed = 0x6A17
        self._loop_msgs: list = []  # (time, Optional[(start, end)])
        self._plan_cache = None
        self._mono_cache = None
        self.PARAMS = Sampler.PARAMS  # may be extended by with_granular_playback

    @property
    def WEIGHT(self):  # reference: weight = active voices (sampler.rs:970)
        return max(self.options.voices, 1)

    @classmethod
    def from_file(cls, path, **kwargs) -> "Sampler":
        return cls(AudioFileBuffer.from_file(path), **kwargs)

    # state keys adopt() carries across topology rebuilds for batched lanes
    # ("buf" stays fresh: constant sample data whose padding may change)
    BATCH_CARRY = ("base", "frac")

    @staticmethod
    def batch_pad_states(nodes, states):
        """LeafBatch stacking hook: zero-pad each lane's sample buffer to
        the group's longest (the live length rides in as the traced
        `_buf_frames` input, so mixed-length banks share one trace).
        Buffers are mm-packed [R, 128, ch] or planar [ch, F] (long-buffer
        gather fallback); the group key pins the format, so a group is
        never mixed."""
        out = []
        bufs = [np.asarray(st["buf"]) for st in states]
        if bufs[0].ndim == 3:  # mm-packed [R, 128, ch]
            axis = 0
        else:  # planar [ch, F] gather fallback
            axis = bufs[0].ndim - 1
        nmax = max(b.shape[axis] for b in bufs)
        for st, buf in zip(states, bufs):
            st = dict(st)
            pad = nmax - buf.shape[axis]
            if pad > 0:
                # extra zero rows/frames == packing of the zero-padded buffer
                width = [(0, 0)] * buf.ndim
                width[axis] = (0, pad)
                buf = np.pad(buf, width)
            st["buf"] = jnp.asarray(buf)
            out.append(st)
        return out

    def source_batch_key(self, ctx):
        """Static-config signature for cross-generator voice batching
        (graph/batching.LeafBatch): samplers whose keys match render as
        ONE vmapped pool; buffer LENGTH is traced (_buf_frames) so it stays
        out of the key.  Granular mode and subclasses render unbatched."""
        if type(self) is not Sampler or self.granular is not None:
            return None
        return (
            self.options.voices,
            self.envelope is not None,
            self.buffer.channels,
            self.buffer.sample_rate,
            self.buffer.loop_mode,
            # the never-loops program omits _loop_* params and merges the
            # two steal lanes into one read — group-static either way
            self._can_loop(),
            round(self.options.fade_out_secs, 9),
            # read-path format must be group-static (mm-packed vs planar
            # gather fallback), and the coarse length bucket bounds the
            # zero-padding waste of mixed-length banks (ops/resample.py)
            rs.use_mm2(self.buffer.frames),
            rs.length_bucket(self.buffer.frames),
        )

    def with_ahdsr(self, attack=0.01, hold=0.0, decay=0.0, sustain=1.0,
                   release=0.05) -> "Sampler":
        self.envelope = AhdsrConfig(attack, hold, decay, sustain, release)
        return self

    def with_granular_playback(self, config: Optional[GranularConfig] = None) -> "Sampler":
        """Enable granular mode (reference: sampler.rs:598-637): the buffer is
        monoized + resampled to the output rate for grain reads, granular +
        modulation parameters activate, and each voice gets a grain pool."""
        self.granular = config or GranularConfig()
        self.PARAMS = Sampler.PARAMS + GRANULAR_PARAMS
        return self

    def with_modulation(self, config) -> "Sampler":
        """Install a custom ModulationConfig (modulation/config.py): extra
        LFO slots and AHDSR Envelope sources become routable to the 7
        granular targets, with their rate/waveform/AHDSR parameters exposed
        as engine-smoothed FourCC parameters (reference: the generalized
        ModulationConfig of src/modulation.rs:135-155; the stock sampler
        config is src/generator/sampler.rs:362-427).  Requires granular
        playback (the matrix only feeds granular targets, like the
        reference sampler)."""
        from ..modulation.matrix import TARGETS as _T
        if self.granular is None:
            raise ValueError("call with_granular_playback() before "
                             "with_modulation(): the sampler matrix feeds "
                             "the granular targets")
        if tuple(config.targets) != _T:
            raise ValueError(f"sampler modulation targets must be {_T}")
        self.mod_config = config
        self.modulation = ModulationRoutings(config)
        have = {p.id for p in self.PARAMS}
        extra = tuple(p for p in config.source_parameters() if p.id not in have)
        self.PARAMS = self.PARAMS + extra
        return self

    def set_loop_range(self, loop_range, time: int = 0):
        """SamplerMessage::SetLoopRange (reference: sampler.rs:51-55,
        validated + applied at :1246-1270): change or disable looping at
        runtime.  Applies at block granularity, like the reference's
        message-queue drain.  ``loop_range`` is (start, end) in source
        frames or None to disable looping."""
        if loop_range is not None:
            start, end = int(loop_range[0]), int(loop_range[1])
            frames = self.buffer.frames
            if not (0 <= start < frames and start < end <= frames):
                raise ValueError(
                    f"Invalid loop range {loop_range!r}; loop must be in "
                    f"range 0..{frames}")
            loop_range = (start, end)
        self._loop_msgs.append((int(time), loop_range))

    def handle_message(self, message, time: int = 0):
        """Generic message hook: accepts ('set_loop_range', range) tuples or
        a bare range/None (reference: Generator::process_message)."""
        if isinstance(message, tuple) and len(message) == 2 and \
                message[0] == "set_loop_range":
            self.set_loop_range(message[1], time=time)
        else:
            self.set_loop_range(message, time=time)

    def _loop_at(self, t: int):
        """Loop range in effect at output frame ``t``."""
        current = self.buffer.loop_range
        for mt, rng in sorted(self._loop_msgs, key=lambda m: m[0]):
            if mt <= t:
                current = rng
        return current

    def _can_loop(self) -> bool:
        """Static host-side gate: can looping EVER engage in this program?
        False when the buffer carries no loop range and no SetLoopRange
        message has been enqueued.  The never-loops program omits the
        ``_loop_*`` params entirely, which (a) drops the fold math and (b)
        lets the sampled path merge its two steal lanes into ONE read
        stream (positions then hold the ramp-read kernel's two-cluster
        contract with the steal jump as the only discontinuity).  The
        first set_loop_range() changes the param pytree structure, i.e.
        one planned retrace — the same pattern as note automation."""
        return self.buffer.loop_range is not None or bool(self._loop_msgs)

    def set_modulation(self, source: str, target: str, amount: float,
                       bipolar: bool = True):
        self.modulation.set(source, target, amount, bipolar)

    def clear_modulation(self, source: str, target: str):
        self.modulation.clear(source, target)

    def _mono_buffer(self, sample_rate: int):
        """Mono buffer at the output rate for grain reads
        (reference: create_granular_sample_buffer, sampler.rs:908-952)."""
        if self._mono_cache is not None and self._mono_cache[0] == sample_rate:
            return self._mono_cache[1]
        data = np.asarray(self.buffer.data[:, :-1], np.float32)  # drop guard
        mono = data.mean(axis=0)
        if self.buffer.sample_rate != sample_rate:
            ratio = self.buffer.sample_rate / sample_rate
            n_out = max(int(len(mono) / ratio), 1)
            pos = np.arange(n_out) * ratio
            k = np.floor(pos).astype(np.int64)
            fr = (pos - k).astype(np.float32)
            def g(i):
                return np.where((i >= 0) & (i < len(mono)), mono[np.clip(i, 0, len(mono) - 1)], 0.0)
            ym1, y0, y1, y2 = g(k - 1), g(k), g(k + 1), g(k + 2)
            c1 = (y1 - ym1) * 0.5
            c2 = ym1 - y0 * 2.5 + y1 * 2.0 - y2 * 0.5
            c3 = (y2 - ym1) * 0.5 + (y0 - y1) * 1.5
            mono = (((c3 * fr + c2) * fr + c1) * fr + y0).astype(np.float32)
        out = jnp.asarray(mono)
        self._mono_cache = (sample_rate, out)
        return out

    def param_initials(self):
        d = {TRANSPOSE.id: self.transpose, FINETUNE.id: self.finetune,
             VOLUME.id: self.options.volume, PANNING.id: self.options.panning}
        env = self.envelope or AhdsrConfig()
        d.update({ENV_ATTACK.id: env.attack, ENV_HOLD.id: env.hold,
                  ENV_DECAY.id: env.decay, ENV_SUSTAIN.id: env.sustain,
                  ENV_RELEASE.id: env.release})
        if self.granular is not None:
            g = self.granular
            d.update({
                GRAIN_OVERLAP.id: GRAIN_OVERLAP.index_of(g.overlap_mode),
                GRAIN_WINDOW.id: GRAIN_WINDOW.index_of(g.window),
                GRAIN_SIZE.id: g.size_ms, GRAIN_DENSITY.id: g.density_hz,
                GRAIN_VARIATION.id: g.variation, GRAIN_SPRAY.id: g.spray,
                GRAIN_PAN_SPREAD.id: g.pan_spread,
                GRAIN_DIRECTION.id: GRAIN_DIRECTION.index_of(g.direction),
                GRAIN_POSITION.id: g.position, GRAIN_STEP.id: g.step,
                LFO1_RATE.id: 1.0, LFO1_WAVE.id: 0, LFO2_RATE.id: 2.0,
                LFO2_WAVE.id: 0,
            })
        return d

    # ------------------------------------------------------------------
    # host-side voice allocation (reference steal policy, sampler.rs:826-860)
    # ------------------------------------------------------------------

    def _voice_end(self, seg: _Segment, ctx_sr: int) -> float:
        """Frame at which the voice becomes free again."""
        if self.envelope is not None:
            if seg.release is math.inf:
                return math.inf
            return min(seg.release + self.envelope.release * ctx_sr * 0.999 + 1, seg.cut)
        # no envelope: one-shot ends at buffer end (note speed scaled)
        speed = 2.0 ** ((seg.note - 60) / 12.0 + self.transpose / 12.0 + self.finetune / 1200.0)
        step = speed * self.buffer.sample_rate / ctx_sr  # source frames/output frame
        nat = seg.start + self.buffer.frames / max(step, 1e-9)
        if self.buffer.loop_range is not None:
            nat = math.inf
        end = nat
        if seg.release is not math.inf:
            end = min(end, seg.release + self.options.fade_out_secs * ctx_sr + 1)
        return min(end, seg.cut)

    def _allocate(self, sample_rate: int):
        """Replay the event timeline into per-voice segment lists."""
        if self._plan_cache is not None and self._plan_cache[0] == (
            len(self.events), sample_rate
        ):
            return self._plan_cache[1]
        voices: list[list[_Segment]] = [[] for _ in range(self.options.voices)]
        by_id: dict[int, _Segment] = {}
        events = sorted(self.events, key=lambda e: (e.time, e.note_id))
        for ev in events:
            t = ev.time
            if ev.kind == "on":
                # find a free voice, else steal
                idx = None
                for v, segs in enumerate(voices):
                    if not segs or self._voice_end(segs[-1], sample_rate) <= t:
                        idx = v
                        break
                if idx is None:
                    # steal priority (reference sampler.rs:826-860):
                    # a) with an envelope, the longest-releasing voice
                    #    (earliest release start; without an envelope the
                    #    reference never checks the release stage), then
                    # b) the oldest active voice by playback id
                    releasing = [
                        (segs[-1].release, v) for v, segs in enumerate(voices)
                        if segs[-1].release <= t
                    ] if self.envelope is not None else []
                    if releasing:
                        idx = min(releasing)[1]
                    else:
                        idx = min(range(len(voices)),
                                  key=lambda v: voices[v][-1].note_id)
                last = voices[idx][-1] if voices[idx] else None
                if last is not None and self._voice_end(last, sample_rate) > t:
                    last.cut = min(last.cut, t)
                seg = _Segment(t, ev.note, ev.note_id, ev.volume, ev.panning)
                voices[idx].append(seg)
                by_id[ev.note_id] = seg
            elif ev.kind == "off":
                seg = by_id.get(ev.note_id)
                if seg is not None and seg.release is math.inf:
                    seg.release = float(max(t, seg.start))
            elif ev.kind == "all_off":
                for segs in voices:
                    for seg in segs:
                        if seg.start <= t and seg.release is math.inf:
                            seg.release = float(t)
            elif ev.kind in ("set_vol", "set_pan", "set_spd"):
                seg = by_id.get(ev.note_id)
                if seg is None or t < seg.start:
                    continue
                if ev.kind == "set_vol":
                    if seg.vol_tl is None:
                        seg.vol_tl = ParamTimeline(initial=seg.volume)
                    seg.vol_tl.set_at(t, ev.value)
                elif ev.kind == "set_pan":
                    if seg.pan_tl is None:
                        seg.pan_tl = ParamTimeline(initial=seg.panning)
                    seg.pan_tl.set_at(t, ev.value)
                else:
                    if seg.spd_tl is None:
                        seg.spd_tl = ParamTimeline(initial=seg.speed0())
                    if ev.glide and ev.glide > 0.0:
                        seg.spd_tl.set_glide_at(t, ev.value, ev.glide,
                                                sample_rate)
                    else:
                        seg.spd_tl.set_at(t, ev.value)
        self._plan_cache = ((len(self.events), sample_rate), voices)
        return voices

    def duration_frames(self, ctx: BuildCtx) -> Optional[int]:
        voices = self._allocate(ctx.sample_rate)
        total = 0
        for segs in voices:
            for seg in segs:
                end = self._voice_end(seg, ctx.sample_rate)
                if end is math.inf:
                    return None
                total = max(total, int(end))
        return total

    def prepare(self, ctx: BuildCtx) -> None:
        # the engine hands us the output rate at program build so lowering
        # never falls back to a default (a 44.1 kHz program lowering before
        # init would mis-allocate voices otherwise)
        self._sr = ctx.sample_rate

    def _max_step_bound(self, voices, include_ratio: bool = True) -> float:
        """Upper bound on any voice's per-sample read step: max note pitch
        over every allocated segment (incl. set_note_speed automation knots)
        x the transpose/finetune parameter bound x the rate ratio.

        ``include_ratio=False`` gives the bound in SOURCE frames per output
        sample for a buffer already resampled to the engine rate (the
        granular mono buffer)."""
        tls = getattr(self, "_timelines", {})

        def tl_max(pid, initial):
            tl = tls.get(pid)
            vals = [float(initial)]
            if tl is not None:
                vals.append(tl.initial)
                vals.extend(tl.values)
            return max(vals)

        pitch = 2.0 ** (tl_max(TRANSPOSE.id, self.transpose) / 12.0
                        + tl_max(FINETUNE.id, self.finetune) / 1200.0)
        spd = 1.0
        for segs in voices:
            for seg in segs:
                spd = max(spd, seg.speed0())
                if seg.spd_tl is not None and seg.spd_tl.values:
                    spd = max(spd, max(seg.spd_tl.values))
        ratio = (self.buffer.sample_rate / self._sr) if include_ratio else 1.0
        return pitch * spd * ratio

    def lower_block_inputs(self, block_start: int, block_len: int):
        if not hasattr(self, "_sr"):
            raise RuntimeError(
                f"{type(self).__name__} lowered before prepare(); the node "
                "must be part of a RenderProgram")
        voices = self._allocate(self._sr)
        v = self.options.voices
        out = {
            "_cont_active": np.zeros(v, np.float32),
            "_cont_note": np.full(v, 60.0, np.float32),
            "_cont_vol": np.zeros(v, np.float32),
            "_cont_pan": np.zeros(v, np.float32),
            "_cont_age0": np.zeros(v, np.int32),
            "_cont_rel": np.full(v, np.inf, np.float32),
            "_cont_spd": np.ones(v, np.float32),
            "_trig_time": np.full(v, block_len, np.int32),
            "_trig_note": np.full(v, 60.0, np.float32),
            "_trig_vol": np.zeros(v, np.float32),
            "_trig_pan": np.zeros(v, np.float32),
            "_trig_rel": np.full(v, np.inf, np.float32),
            "_trig_spd": np.ones(v, np.float32),
        }
        # Per-note automation events per lane (cont "ca" / trig "ta"), K
        # knots per block so speed-glide ramps lower losslessly.  The event
        # arrays are only emitted once ANY per-note automation exists: the
        # no-automation render then compiles the plain scalar voice path
        # (zero overhead, the common case), and the first set_note_* event
        # retraces the block step once with the event inputs present.
        has_auto = any(ev.kind.startswith("set_") for ev in self.events)
        ka = max(4, block_len // 512)
        if has_auto:
            for lane in ("ca", "ta"):
                for nm in ("vol", "pan", "spd"):
                    out[f"_{lane}_{nm}_t"] = np.full((v, ka), block_len,
                                                     np.int32)
                    out[f"_{lane}_{nm}_v"] = np.zeros((v, ka), np.float32)
                    out[f"_{lane}_{nm}_r"] = np.zeros((v, ka), np.float32)

        def _lower_auto(seg, lane, vi):
            if not has_auto:
                return
            for nm, tl in (("vol", seg.vol_tl), ("pan", seg.pan_tl),
                           ("spd", seg.spd_tl)):
                if tl is not None:
                    t_, v_, r_ = tl.lower_block(block_start, block_len, ka)
                    out[f"_{lane}_{nm}_t"][vi] = t_
                    out[f"_{lane}_{nm}_v"][vi] = v_
                    out[f"_{lane}_{nm}_r"][vi] = r_
        if self.granular is not None:
            out["_mod_amt"] = self.modulation.amounts.copy()
            out["_mod_bip"] = self.modulation.bipolar.copy()
        if getattr(self, "buffer", None) is not None and (
                self.granular is not None or rs.use_mm2(self.buffer.frames)):
            # read-window bucket (monotone: shrinking would ping-pong
            # retraces); rides in the tag's SHAPE so growth retraces the
            # step with wider windows (see ops/resample.speed_bucket)
            if self.granular is not None:
                # grain read speed = voice speed x 2^(sem/12), |sem| <= var
                # <= 1 semitone (granular.rs:700-717 variation draws); the
                # mono buffer is pre-resampled to the engine rate (ratio 1).
                # The config max_read_speed caps the bucket either way.
                b = min(rs.speed_bucket(
                            self._max_step_bound(voices, include_ratio=False)
                            * 2.0 ** (1.0 / 12.0)),
                        rs.speed_bucket(self.granular.max_read_speed))
            else:
                b = rs.speed_bucket(self._max_step_bound(voices))
            self._spd_bucket = max(b, getattr(self, "_spd_bucket", 0))
            out["_spd_tag"] = np.zeros((self._spd_bucket + 1,), np.float32)
        if getattr(self, "buffer", None) is not None:
            # _loop_* params exist only when looping can engage (see
            # _can_loop: key presence is the static never-loops gate);
            # granular always lowers them (loop_norm consumes them)
            if self.granular is not None or self._can_loop():
                rng = self._loop_at(block_start)
                out["_loop_on"] = np.float32(0.0 if rng is None else 1.0)
                out["_loop_start"] = np.float32(0.0 if rng is None else rng[0])
                out["_loop_end"] = np.float32(
                    self.buffer.frames if rng is None else rng[1])
            # traced buffer length: lets homogeneous samplers with
            # different-length buffers share one vmapped trace
            # (graph/batching.LeafBatch)
            out["_buf_frames"] = np.float32(self.buffer.frames)
        for vi, segs in enumerate(voices):
            cont = None
            trig = None
            for seg in segs:
                if seg.start < block_start and max(seg.cut, seg.start) > block_start:
                    cont = seg
                elif block_start <= seg.start < block_start + block_len:
                    trig = seg  # keep the last
            if cont is not None:
                out["_cont_active"][vi] = 1.0
                out["_cont_note"][vi] = cont.note
                out["_cont_vol"][vi] = (cont.vol_tl.value_at(block_start)
                                        if cont.vol_tl else cont.volume)
                out["_cont_pan"][vi] = (cont.pan_tl.value_at(block_start)
                                        if cont.pan_tl else cont.panning)
                out["_cont_spd"][vi] = (cont.spd_tl.value_at(block_start)
                                        if cont.spd_tl else cont.speed0())
                out["_cont_age0"][vi] = block_start - cont.start
                _lower_auto(cont, "ca", vi)
                if cont.release is not math.inf:
                    out["_cont_rel"][vi] = cont.release - cont.start
                # a cut without retrigger in this block: emulate via trig_time
                if cont.cut is not math.inf and cont.cut < block_start + block_len and trig is None:
                    out["_trig_time"][vi] = int(cont.cut) - block_start
            if trig is not None:
                out["_trig_time"][vi] = trig.start - block_start
                out["_trig_note"][vi] = trig.note
                out["_trig_vol"][vi] = trig.volume
                out["_trig_pan"][vi] = trig.panning
                out["_trig_spd"][vi] = trig.speed0()
                if trig.release is not math.inf:
                    out["_trig_rel"][vi] = trig.release - trig.start
                _lower_auto(trig, "ta", vi)
        return out

    # ------------------------------------------------------------------
    # device-side rendering
    # ------------------------------------------------------------------

    def init_state(self, ctx: BuildCtx):
        self._sr = ctx.sample_rate
        v = self.options.voices
        st = {
            "base": jnp.zeros((v,), jnp.int32),
            "frac": jnp.zeros((v,), jnp.float32),
            # device-resident sample data (see FileSource.init_state);
            # mm-packed for the gather-free two-stage one-hot read unless the
            # buffer is long enough that the gather wins (rs.use_mm2)
            "buf": (jnp.asarray(self._mono_buffer(ctx.sample_rate))
                    if self.granular is not None
                    else jnp.asarray(rs.mm_pack(np.asarray(self.buffer.data)))
                    if rs.use_mm2(self.buffer.frames)
                    else jnp.asarray(self.buffer.data)),
        }
        if self.granular is not None:
            one = grain_state_init()
            st["grains"] = jax.tree.map(
                lambda x: jnp.broadcast_to(x, (v,) + x.shape).copy(), one
            )
            from .granular import grain_windows
            # device-resident window LUT (a jit argument, not a constant)
            st["gwin"] = jnp.asarray(grain_windows().reshape(-1))
        return st

    def _envelope_params(self, params):
        env0 = lambda pid: params[pid][0]
        return ahdsr_ops.ahdsr_params(
            self._sr, env0(ENV_ATTACK.id), env0(ENV_HOLD.id), env0(ENV_DECAY.id),
            env0(ENV_SUSTAIN.id), env0(ENV_RELEASE.id),
        )

    def process(self, state, x, params, ctx: BuildCtx):
        if self.granular is not None:
            return self._process_granular(state, params, ctx)
        return self._process_sampled(state, params, ctx)

    def _process_sampled(self, state, params, ctx: BuildCtx):
        n = ctx.block_frames
        sr = ctx.sample_rate
        frames = self.buffer.frames
        ratio = self.buffer.sample_rate / sr
        buf = state["buf"]

        i = jnp.arange(n, dtype=jnp.float32)
        ii = jnp.arange(n, dtype=jnp.int32)
        pitch = jnp.exp2(params[TRANSPOSE.id] / 12.0 + params[FINETUNE.id] / 1200.0)  # [n]
        base_vol = params[VOLUME.id]
        base_pan = params[PANNING.id]
        env_p = self._envelope_params(params) if self.envelope is not None else None

        fade_log1m = math.log1p(-(1.0 - math.exp(
            -1.0 / max(sr * self.options.fade_out_secs / math.log(100.0), 1e-9)
        )))

        frames_live = params.get("_buf_frames", jnp.float32(frames))

        # loop bounds are traced per-block scalars so SetLoopRange messages
        # change or disable looping without recompiling; when looping can
        # NEVER engage the keys are absent (static fast path, _can_loop)
        never_loops = "_loop_on" not in params
        if never_loops:
            def fold(pos):
                return pos, pos < frames_live
        else:
            loop_on = params["_loop_on"] > 0.5
            loop_s = params["_loop_start"]
            loop_e = params["_loop_end"]

            def fold(pos):
                folded = rs.loop_fold(pos, loop_s, loop_e,
                                      self.buffer.loop_mode)
                p = jnp.where(loop_on, folded, pos)
                live = loop_on | (pos < frames_live)
                return p, live

        use_mm2 = rs.use_mm2(self.buffer.frames)
        smax = 2.0 ** (params["_spd_tag"].shape[0] - 1) if use_mm2 else 0.0

        def lane(vol, pan, age, rel, mask, audio):
            """Post-read half of one lane: ``audio`` [ch_in, n] from the
            hoisted read below, age [n] runs, rel scalar (runs since note
            start), mask [n] (activity & fold-liveness)."""
            mono = jnp.mean(audio, axis=0) if self.buffer.channels > 1 else audio[0]
            if self.buffer.channels >= 2 and ctx.channels >= 2:
                sig = jnp.stack([audio[0], audio[1]])
            else:
                sig = jnp.stack([mono] * ctx.channels)
            m = mask.astype(jnp.float32)
            if env_p is not None:
                env = ahdsr_ops.ahdsr_block(env_p, 1.0, age[0], rel + 0.0, n)
                # ahdsr_block takes scalar age0; ages here are contiguous
            else:
                held = age.astype(jnp.float32) < rel
                k = age.astype(jnp.float32) - rel + 1.0
                down = jnp.exp(fade_log1m * jnp.maximum(k, 0.0))
                env = jnp.where(held, 1.0, jnp.where(down < 1e-4, 0.0, down))
            eff_vol = base_vol * vol
            eff_pan = jnp.clip(base_pan + pan, -1.0, 1.0)
            l, r = panning_factors(eff_pan)
            g = env * eff_vol * m
            out = sig * g[None, :]
            if ctx.channels >= 2:
                out = out.at[0].multiply(l).at[1].multiply(r)
            return out

        def auto_vals(current, auto, lane_key, nm):
            """Per-sample automated value from the per-voice event arrays
            (reference applies SetVolume/SetPanning/SetSpeed sample-split;
            here via the shared stepped/ramp evaluator).  Without automation
            the scalar passes straight through (static fast path)."""
            key = f"_{lane_key}_{nm}_t"
            if key not in auto:
                return current
            ev = SegmentEvents(auto[key], auto[f"_{lane_key}_{nm}_v"])
            return step_targets(current, ev, auto[f"_{lane_key}_{nm}_r"], n)[1]

        clamp = use_mm2

        def voice_pos(base0, frac0, c_act, c_vol, c_pan, c_age0, c_spd,
                      t_time, t_vol, t_pan, t_spd, auto):
            """Phase A: per-voice positions/masks/automated gains for the
            two steal lanes; the reads are hoisted out of the vmap."""
            # lane A: continuing note (carried position)
            vol_a = auto_vals(c_vol, auto, "ca", "vol")
            pan_a = auto_vals(c_pan, auto, "ca", "pan")
            spd_a = auto_vals(c_spd, auto, "ca", "spd")
            speed_a = pitch * spd_a * np.float32(ratio)
            mask_a = (c_act > 0.5) & (ii < t_time)
            if clamp:  # read-window contract (never binds in-bucket)
                speed_a = jnp.minimum(speed_a, np.float32(smax))
            steps_a = jnp.where(mask_a, speed_a, 0.0)
            rel_a = jnp.cumsum(steps_a)
            pos_a = base0.astype(jnp.float32) + frac0 + jnp.concatenate(
                [jnp.zeros((1,), jnp.float32), rel_a[:-1]]
            )
            p_a, live_a = fold(pos_a)

            # lane B: (re)triggered note, position restarts at 0
            vol_b = auto_vals(t_vol, auto, "ta", "vol")
            pan_b = auto_vals(t_pan, auto, "ta", "pan")
            spd_b = auto_vals(t_spd, auto, "ta", "spd")
            speed_b = pitch * spd_b * np.float32(ratio)
            has_trig = t_time < n
            mask_b = (ii >= t_time) & has_trig & (t_vol > 0.0)
            if clamp:
                speed_b = jnp.minimum(speed_b, np.float32(smax))
            steps_b = jnp.where(mask_b, speed_b, 0.0)
            rel_b = jnp.cumsum(steps_b)
            pos_b = jnp.concatenate([jnp.zeros((1,), jnp.float32), rel_b[:-1]])
            p_b, live_b = fold(pos_b)

            # end-of-block position state
            end_pos = jnp.where(mask_b[-1] | (has_trig & (t_vol > 0.0)),
                                rel_b[-1], pos_a[-1] + steps_a[-1])
            new_base = jnp.floor(end_pos)
            return ((p_a, mask_a & live_a, vol_a, pan_a),
                    (p_b, mask_b & live_b, vol_b, pan_b),
                    new_base.astype(jnp.int32), end_pos - new_base)

        auto = {k: jnp.asarray(v) for k, v in params.items()
                if k.startswith(("_ca_", "_ta_"))}
        la, lb, new_base, new_frac = jax.vmap(voice_pos)(
            state["base"], state["frac"],
            params["_cont_active"], params["_cont_vol"],
            params["_cont_pan"], params["_cont_age0"],
            params["_cont_spd"], params["_trig_time"],
            params["_trig_vol"], params["_trig_pan"],
            params["_trig_spd"], auto,
        )

        # hoisted read: both steal lanes of every voice in one call
        v = la[0].shape[0]
        if never_loops:
            # merged single stream per voice: the steal hard-cut makes the
            # two lanes' live masks disjoint in time (lane A strictly
            # ii < t_time, lane B strictly ii >= t_time), so ONE position
            # stream with a single jump at the steal point serves both
            # lanes — half the read's position bill.  Valid only when
            # looping never engages: the steal jump is then the stream's
            # only discontinuity, so the mm2 two-band contract holds; a
            # loop fold in the same chunk would add a third band (which is
            # why the loopable program keeps 2V streams).
            t_time = params["_trig_time"]
            switch = ((t_time < n) & (params["_trig_vol"] > 0.0))[:, None]
            pos_all = jnp.where((ii[None, :] >= t_time[:, None]) & switch,
                                lb[0], la[0])  # [V, n]
        else:
            pos_all = jnp.concatenate([la[0], lb[0]])  # [2V, n] folded
        if use_mm2:
            aud = jax.vmap(lambda p: rs.hermite_read_mm2(
                buf, p, smax=smax))(pos_all)
        else:  # very long buffer: the O(n) gather wins (use_mm2 cap)
            aud = jax.vmap(lambda p: rs.hermite_read(buf, p))(pos_all)

        def voice_post(aud_a, aud_b, m_a, vol_a, pan_a, m_b, vol_b, pan_b,
                       c_age0, c_rel, t_time, t_rel):
            out = lane(vol_a, pan_a, c_age0 + ii, c_rel, m_a, aud_a)
            return out + lane(vol_b, pan_b, ii - t_time, t_rel, m_b, aud_b)

        aud_a, aud_b = (aud, aud) if never_loops else (aud[:v], aud[v:])
        outs = jax.vmap(voice_post)(
            aud_a, aud_b, la[1], la[2], la[3], lb[1], lb[2], lb[3],
            params["_cont_age0"], params["_cont_rel"],
            params["_trig_time"], params["_trig_rel"],
        )
        mix = jnp.sum(outs, axis=0)  # [ch, n]
        return {"base": new_base, "frac": new_frac, "buf": buf}, mix

    def _process_granular(self, state, params, ctx: BuildCtx):
        """Granular voice rendering: per-voice grain pools under vmap, with
        the modulation matrix feeding the 7 granular targets."""
        n = ctx.block_frames
        sr = ctx.sample_rate
        mono = state["buf"]
        gwin = state["gwin"]
        frames = mono.shape[0]
        # runtime loop range, normalized over the source length
        inv_len = 1.0 / float(self.buffer.frames)
        loop_norm = (params["_loop_on"],
                     params["_loop_start"] * np.float32(inv_len),
                     params["_loop_end"] * np.float32(inv_len))

        i = jnp.arange(n, dtype=jnp.int32)
        frame0 = params["_frame0"].astype(jnp.int32)
        pitch = jnp.exp2(params[TRANSPOSE.id] / 12.0 + params[FINETUNE.id] / 1200.0)
        base_vol = params[VOLUME.id]
        base_pan = params[PANNING.id]
        env_p = self._envelope_params(params) if self.envelope is not None else None
        max_trig = int(math.ceil(100.0 * n / sr)) + 2

        # grain read-speed cap: the config cap, tightened to the host-side
        # speed bound (the _spd_tag bucket, lower_block_inputs); the
        # in-graph gspeed clamp (granular.py alloc) never binds while the
        # bound holds
        eff_mrs = float(self.granular.max_read_speed)
        if "_spd_tag" in params:
            eff_mrs = min(eff_mrs, 2.0 ** (params["_spd_tag"].shape[-1] - 1))

        overlap = params[GRAIN_OVERLAP.id][0].astype(jnp.int32)
        wmode = params[GRAIN_WINDOW.id].astype(jnp.int32)
        direction = params[GRAIN_DIRECTION.id].astype(jnp.int32)
        # config-driven modulation sources (LFO slots, Envelope slots,
        # velocity, keytracking); voice-independent payloads built here,
        # per-voice values evaluated under the vmap below
        mod_specs = build_source_specs(self.mod_config, params, sr)
        src_bip = source_polarity(self.mod_config)
        amt = jnp.asarray(params["_mod_amt"], jnp.float32)
        bip = jnp.asarray(params["_mod_bip"], jnp.float32)

        def voice_prolog(c_act, c_note, c_vol, c_pan, c_age0, c_rel, c_spd,
                         t_time, t_note, t_vol, t_pan, t_rel, t_spd,
                         voice_idx):
            """Per-voice note logic + modulation -> the granular engine's
            per-sample parameter dict and the note-start frame."""
            has_trig = (t_time < n) & (t_vol > 0.0)
            in_b = i >= t_time
            age = jnp.where(in_b & has_trig, i - t_time, c_age0 + i)
            note = jnp.where(in_b & has_trig, t_note, c_note)
            nvol = jnp.where(in_b & has_trig, t_vol, c_vol * c_act)
            npan = jnp.where(in_b & has_trig, t_pan, c_pan)
            rel = jnp.where(in_b & has_trig, t_rel, c_rel)
            active = jnp.where(in_b & has_trig, True, c_act > 0.5)
            held = active & (age.astype(jnp.float32) < rel) & (nvol > 0.0)

            note_start = jnp.where(
                has_trig, frame0 + t_time,
                jnp.where(c_act > 0.5, frame0 - c_age0, jnp.int32(NEVER)),
            )
            # per-note speed automation applies at block granularity for
            # grains (the pool re-reads speed per trigger, granular.rs:504)
            spd = jnp.where(in_b & has_trig, t_spd, c_spd)
            speed = pitch * spd
            eff_vol = base_vol * nvol
            eff_pan = jnp.clip(base_pan + npan, -1.0, 1.0)

            # modulation sources/targets for this voice
            src = eval_sources(mod_specs, age, nvol, note, rel, n,
                               seed=self.seed ^ (0x9E37 * (voice_idx + 1)))
            mods = apply_matrix(src, amt, bip, src_bip)  # [7, n]

            per_sample = dict(
                held=held, speed=speed, vol=eff_vol, pan=eff_pan,
                size_ms=params[GRAIN_SIZE.id] * (1.0 + mods[0]),
                density=params[GRAIN_DENSITY.id] * (1.0 + mods[1]),
                variation=params[GRAIN_VARIATION.id] + mods[2],
                spray=params[GRAIN_SPRAY.id] + mods[3],
                pan_spread=params[GRAIN_PAN_SPREAD.id] + mods[4],
                position=params[GRAIN_POSITION.id],
                pos_mod=mods[5],
                step=params[GRAIN_STEP.id],
                speed_mod=mods[6],
                window_mode=wmode, direction=direction,
            )
            return per_sample, note_start

        def voice_env_post(audio, c_act, c_age0, c_rel, t_time, t_rel,
                           t_vol):
            """Voice-level AHDSR after the grain mix (voice.rs:470-486)."""
            has_trig = (t_time < n) & (t_vol > 0.0)
            in_b = i >= t_time
            active = jnp.where(in_b & has_trig, True, c_act > 0.5)
            if env_p is not None:
                env_a = ahdsr_ops.ahdsr_block(env_p, 1.0, c_age0, c_rel, n)
                env_b = ahdsr_ops.ahdsr_block(env_p, 1.0, -t_time, t_rel, n)
                env = jnp.where(in_b & has_trig, env_b,
                                env_a * (c_act > 0.5).astype(jnp.float32))
                return audio * env[None, :]
            return audio * active.astype(jnp.float32)[None, :]

        def render_voice(gr_state, c_act, c_note, c_vol, c_pan, c_age0, c_rel,
                         c_spd, t_time, t_note, t_vol, t_pan, t_rel, t_spd,
                         voice_idx):
            per_sample, note_start = voice_prolog(
                c_act, c_note, c_vol, c_pan, c_age0, c_rel, c_spd, t_time,
                t_note, t_vol, t_pan, t_rel, t_spd, voice_idx)

            def run_chunk(gs, t0, cn, mt):
                sl = {k: jax.lax.dynamic_slice(v, (t0,), (cn,))
                      for k, v in per_sample.items()}
                return granular_voice_block(
                    gs, frame0=frame0 + t0, n=cn, sr=sr, mono_buf=mono,
                    loop_range=loop_norm, window_table=gwin,
                    note_start=note_start, overlap_mode=overlap,
                    seed=self.seed ^ (voice_idx + 1) * 0x51ED,
                    max_triggers=mt, max_read_speed=eff_mrs, **sl)

            # Big blocks run the grain engine as a scan over sub-chunks: a
            # slot is only reusable once its grain expired BEFORE the chunk
            # being rendered (the pool allocates-then-renders), so the 100-
            # slot pool supports at most ~pool/density seconds per chunk —
            # chunking restores that invariant at any block size while
            # keeping one dispatch per block.
            if n > _GRANULAR_CHUNK and n % _GRANULAR_CHUNK == 0:
                cn = _GRANULAR_CHUNK
                mt = int(math.ceil(100.0 * cn / sr)) + 2

                def chunk_body(gs, ci):
                    return run_chunk(gs, ci * cn, cn, mt)

                gr_state, autos = jax.lax.scan(
                    chunk_body, gr_state,
                    jnp.arange(n // cn, dtype=jnp.int32))
                audio = jnp.moveaxis(autos, 0, 1).reshape(autos.shape[1], n)
            else:
                gr_state, audio = run_chunk(gr_state, jnp.int32(0), n,
                                            max_trig)

            return gr_state, voice_env_post(audio, c_act, c_age0, c_rel,
                                            t_time, t_rel, t_vol)

        voice_idx = jnp.arange(self.options.voices, dtype=jnp.int32)
        voice_rows = (
            params["_cont_active"], params["_cont_note"], params["_cont_vol"],
            params["_cont_pan"], params["_cont_age0"], params["_cont_rel"],
            params["_cont_spd"], params["_trig_time"], params["_trig_note"],
            params["_trig_vol"], params["_trig_pan"], params["_trig_rel"],
            params["_trig_spd"], voice_idx,
        )

        grains, outs = jax.vmap(render_voice)(state["grains"], *voice_rows)
        mix = jnp.sum(outs, axis=0)
        if ctx.channels == 1:
            mix = ((mix[0] + mix[1]) * 0.5)[None, :]
        elif ctx.channels > 2:
            mix = jnp.concatenate(
                [mix, jnp.zeros((ctx.channels - 2, n), mix.dtype)], axis=0
            )
        new_state = dict(state)
        new_state["grains"] = grains
        return new_state, mix
