"""Polyphonic synth generator from a SynthDef (the FunDspGenerator analog).

Behavioural spec: reference src/generator/fundsp.rs — a voice-factory
closure produces per-voice FunDSP graphs driven by (gate, freq, volume,
pan) shared vars; note events allocate voices with the sampler's steal
policy; frequency glides morph exponentially between notes
(src/generator/fundsp/voice.rs:312-346, GlideState :538-560).

Formulation: the same host-side allocator as the Sampler lowers notes to
per-voice lane descriptors; the SynthDef renders under vmap with per-sample
gate/freq arrays.  Glides are exact exponential-in-pitch trajectories
computed analytically from the note ages.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..graph.nodes import BuildCtx
from ..ops.convert import panning_factors
from ..ops.smoothing import SegmentEvents, step_targets
from ..params import DecibelScaling, FloatParameter, format_gain, format_pan
from ..sources.synth import SynthContext, SynthDef
from .base import Generator, GeneratorPlaybackOptions
from .sampler import Sampler, _Segment  # reuse the allocator machinery

NEVER = np.iinfo(np.int32).max

VOLUME = FloatParameter("SVOL", "Volume", 1e-6, 15.848932, 1.0,
                        scaling=DecibelScaling(-60.0, 24.0), formatter=format_gain)
PANNING = FloatParameter("SPAN", "Panning", -1.0, 1.0, 0.0, formatter=format_pan)


def note_to_hz(note):
    return 440.0 * jnp.exp2((jnp.asarray(note, jnp.float32) - 69.0) / 12.0)


class SynthGenerator(Generator):
    """Polyphonic note-driven synth built from a SynthDef."""

    PARAMS = (VOLUME, PANNING)

    def __init__(self, synth: SynthDef,
                 options: Optional[GeneratorPlaybackOptions] = None,
                 release_secs: float = 0.2, glide_secs: float = 0.0, name=None):
        super().__init__(options, name)
        self.synth = synth
        self.release_secs = float(release_secs)  # voice considered free after
        self.glide_secs = float(glide_secs)
        self.granular = None  # allocator shim (shared with Sampler)
        self._plan_cache = None
        # user-declared FourCC parameters (reference: fundsp Shared vars,
        # src/generator/fundsp.rs:88-99 + fundsp/parameter.rs:1-123)
        self.PARAMS = SynthGenerator.PARAMS + tuple(synth.params)
        self.mod_config = None
        self.modulation = None

    def with_modulation(self, config) -> "SynthGenerator":
        """Install a ModulationConfig whose targets are this synth's user
        parameter ids: per-voice matrix outputs arrive as
        ``SynthContext.mods[target_id]`` arrays for the SynthDef to combine
        (reference: flexible ModulationConfig + shared output buffers,
        src/generator/fundsp/modulation.rs:159-220)."""
        from ..modulation.matrix import ModulationRoutings

        valid = {p.id for p in self.synth.params}
        bad = [t for t in config.targets if t not in valid]
        if bad:
            raise ValueError(
                f"modulation targets {bad} are not user parameters of this "
                f"synth (have {sorted(valid)})")
        self.mod_config = config
        self.modulation = ModulationRoutings(config)
        have = {p.id for p in self.PARAMS}
        self.PARAMS = self.PARAMS + tuple(
            p for p in config.source_parameters() if p.id not in have)
        return self

    def set_modulation(self, source: str, target: str, amount: float,
                       bipolar: bool = True):
        if self.modulation is None:
            raise ValueError("no ModulationConfig installed; call "
                             "with_modulation() first")
        self.modulation.set(source, target, amount, bipolar)

    def clear_modulation(self, source: str, target: str):
        if self.modulation is not None:
            self.modulation.clear(source, target)

    @property
    def WEIGHT(self):
        return max(2, self.options.voices // 2)

    def param_initials(self):
        out = {VOLUME.id: self.options.volume, PANNING.id: self.options.panning}
        for p in self.synth.params:
            out[p.id] = p.default
        return out

    # voice allocation: reuse the Sampler's host allocator with a fixed
    # release duration (and its prepare(): lowering needs the output rate)
    _allocate = Sampler._allocate
    prepare = Sampler.prepare

    def lower_block_inputs(self, block_start: int, block_len: int):
        out = Sampler.lower_block_inputs(self, block_start, block_len)
        if self.modulation is not None:
            out["_mod_amt"] = self.modulation.amounts.copy()
            out["_mod_bip"] = self.modulation.bipolar.copy()
        return out

    def _voice_end(self, seg, ctx_sr: int) -> float:
        if seg.release is math.inf:
            return math.inf
        return min(seg.release + self.release_secs * ctx_sr + 1, seg.cut)

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

    def init_state(self, ctx: BuildCtx):
        self._sr = ctx.sample_rate
        v = self.options.voices
        one = self.synth.init(ctx)
        return {
            "synth": jax.tree.map(
                lambda x: jnp.broadcast_to(x, (v,) + jnp.shape(x)).copy(), one
            ),
        }

    def process(self, state, x, params, ctx: BuildCtx):
        n = ctx.block_frames
        frame0 = params["_frame0"].astype(jnp.int32)
        i = jnp.arange(n, dtype=jnp.int32)
        base_vol = params[VOLUME.id]
        base_pan = params[PANNING.id]
        glide = self.glide_secs
        # generator-level user params: shared across voices (broadcast
        # under the voice vmap), already smoothed per sample by the engine
        uparams = {p.id: params[p.id] for p in self.synth.params}
        if self.mod_config is not None:
            from ..modulation.matrix import (
                apply_matrix, build_source_specs, eval_sources, source_polarity)
            mod_specs = build_source_specs(self.mod_config, params,
                                           ctx.sample_rate)
            src_bip = source_polarity(self.mod_config)
            mod_amt = jnp.asarray(params["_mod_amt"], jnp.float32)
            mod_bip = jnp.asarray(params["_mod_bip"], jnp.float32)

        def auto_vals(current, auto, lane_key, nm):
            key = f"_{lane_key}_{nm}_t"
            if key not in auto:  # static fast path: no automation lowered
                return current
            ev = SegmentEvents(auto[key], auto[f"_{lane_key}_{nm}_v"])
            return step_targets(current, ev, auto[f"_{lane_key}_{nm}_r"], n)[1]

        def render_voice(syn_state, c_act, c_note, c_vol, c_pan, c_age0, c_rel,
                         c_spd, t_time, t_note, t_vol, t_pan, t_rel, t_spd,
                         auto, voice_idx):
            has_trig = (t_time < n) & (t_vol > 0.0)
            in_b = (i >= t_time) & has_trig
            age = jnp.where(in_b, i - t_time, c_age0 + i)
            note = jnp.where(in_b, t_note, c_note)
            # per-note automation (reference: fundsp voice set_volume /
            # set_panning / set_speed with glide, fundsp/voice.rs:312-380)
            vel = jnp.where(in_b, auto_vals(t_vol, auto, "ta", "vol"),
                            auto_vals(c_vol, auto, "ca", "vol"))
            npan = jnp.where(in_b, auto_vals(t_pan, auto, "ta", "pan"),
                             auto_vals(c_pan, auto, "ca", "pan"))
            # speed arrays carry the absolute multiplier (initial
            # 2^((note-60)/12)); normalising by that makes freq_mult == 1
            # exactly when unautomated
            spd = jnp.where(in_b, auto_vals(t_spd, auto, "ta", "spd"),
                            auto_vals(c_spd, auto, "ca", "spd"))
            freq_mult = spd / jnp.exp2((note - 60.0) / 12.0)
            rel = jnp.where(in_b, t_rel, c_rel)
            active = jnp.where(in_b, True, c_act > 0.5)
            gate = (active & (age.astype(jnp.float32) < rel) & (age >= 0)).astype(jnp.float32)

            if glide > 0.0:
                # exponential-in-pitch glide from the previous note on retrigger
                gsamples = max(glide * ctx.sample_rate, 1.0)
                prog = jnp.clip((i - t_time).astype(jnp.float32) / gsamples, 0.0, 1.0)
                pitch = jnp.where(in_b, c_note + (t_note - c_note) * prog, note)
                freq = note_to_hz(jnp.where(has_trig & (c_act > 0.5), pitch, note))
            else:
                freq = note_to_hz(note)
            freq = freq * freq_mult

            if self.mod_config is not None:
                src = eval_sources(
                    mod_specs, age, vel, note, rel, n,
                    seed=0x7157 ^ (0x9E37 * (voice_idx + 1)))
                m = apply_matrix(src, mod_amt, mod_bip, src_bip)  # [T, n]
                mods = {t: m[k] for k, t in enumerate(self.mod_config.targets)}
            else:
                mods = {}
            sctx = SynthContext(freq=freq, gate=gate, velocity=vel, age=age,
                                release_age=rel, sample_rate=ctx.sample_rate,
                                block_frames=n, params=uparams, mods=mods)
            syn_state, audio = self.synth.render(syn_state, sctx)
            if audio.ndim == 1:
                audio = jnp.stack([audio] * ctx.channels)
            g = base_vol * vel * active.astype(jnp.float32)
            audio = audio * g[None, :]
            if ctx.channels >= 2:
                l, r = panning_factors(jnp.clip(base_pan + npan, -1.0, 1.0))
                audio = audio.at[0].multiply(l).at[1].multiply(r)
            return syn_state, audio

        auto = {k: jnp.asarray(v) for k, v in params.items()
                if k.startswith(("_ca_", "_ta_"))}
        synth_states, outs = jax.vmap(render_voice)(
            state["synth"],
            params["_cont_active"], params["_cont_note"], params["_cont_vol"],
            params["_cont_pan"], params["_cont_age0"], params["_cont_rel"],
            params["_cont_spd"], params["_trig_time"], params["_trig_note"],
            params["_trig_vol"], params["_trig_pan"], params["_trig_rel"],
            params["_trig_spd"], auto,
            jnp.arange(self.options.voices, dtype=jnp.int32),
        )
        return {"synth": synth_states}, jnp.sum(outs, axis=0)
