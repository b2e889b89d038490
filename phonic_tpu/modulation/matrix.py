"""Per-voice modulation matrix.

Behavioural spec: reference src/modulation/ — sources LFO1/LFO2 (bipolar,
rate 0.01-20 Hz + waveform), VELOCITY and KEYTRACK (unipolar, note/127)
(src/generator/sampler.rs:362-427); routing accumulates with polarity
transforms (src/modulation/matrix.rs:196-246): bipolar->unipolar maps
(v+1)/2, unipolar->bipolar maps (v-0.5)*2, matching polarities pass through;
each routing scales by its amount.

Formulation: routings live in a dense ``amounts[S, T]`` +
``bipolar[S, T]`` pair delivered as per-block inputs, so add/clear/update
modulation at runtime never recompiles.  LFO phases are analytic functions
of the note age (they restart at note-on), so the matrix carries no device
state; the reference computes sources in 64-sample chunks
(src/modulation/processor.rs:14), we compute them per sample.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..ops import lfo as lfo_ops

SOURCES = ("LFO1", "LFO2", "VELM", "KEYM")
SOURCE_BIPOLAR = (True, True, False, False)

# the 7 modulatable granular targets (src/generator/sampler/modulation.rs)
TARGETS = ("GSIZ", "GDEN", "GVAR", "GSPY", "GPAN", "GPOS", "GSTP")


class ModulationRoutings:
    """Host-side routing table -> dense device tensors.  Sized by a
    ModulationConfig (modulation/config.py); defaults to the sampler's
    stock LFO1/LFO2/VELM/KEYM -> 7 granular targets."""

    def __init__(self, config=None):
        if config is None:
            from .config import default_sampler_config
            config = default_sampler_config()
        self.config = config
        self.source_ids = list(config.source_ids)
        self.target_ids = list(config.targets)
        self.amounts = np.zeros(
            (len(self.source_ids), len(self.target_ids)), np.float32)
        self.bipolar = np.zeros_like(self.amounts)

    def _index(self, source: str, target: str):
        if source not in self.source_ids:
            raise KeyError(f"unknown modulation source {source!r}; "
                           f"have {self.source_ids}")
        if target not in self.target_ids:
            raise KeyError(f"unknown modulation target {target!r}; "
                           f"have {self.target_ids}")
        return self.source_ids.index(source), self.target_ids.index(target)

    def set(self, source: str, target: str, amount: float, bipolar: bool = True):
        s, t = self._index(source, target)
        self.amounts[s, t] = amount
        self.bipolar[s, t] = 1.0 if bipolar else 0.0

    def clear(self, source: str, target: str):
        s, t = self._index(source, target)
        self.amounts[s, t] = 0.0

    def clear_all(self):
        self.amounts[:] = 0.0


def source_values(age, velocity, note, lfo1_inc, lfo1_wf, lfo2_inc, lfo2_wf,
                  n: int, seed: int = 0):
    """[S, n] per-voice source values.  ``age`` int32[n] = runs since
    note-on (LFO phase = age * inc, restarting per note); velocity/note are
    scalars or [n] arrays."""
    agef = jnp.maximum(age.astype(jnp.float32), 0.0)

    def lfo(inc, wf, salt):
        raw = agef * inc
        phase = raw - jnp.floor(raw)
        wraps = jnp.floor(raw).astype(jnp.int32)
        return _waveform_at(wf, phase, wraps, seed + salt)

    l1 = lfo(lfo1_inc, lfo1_wf, 0x11)
    l2 = lfo(lfo2_inc, lfo2_wf, 0x22)
    vel = jnp.broadcast_to(jnp.asarray(velocity, jnp.float32), (n,))
    key = jnp.broadcast_to(jnp.asarray(note, jnp.float32) / 127.0, (n,))
    return jnp.stack([l1, l2, vel, key])


def _waveform_at(wf, phase, wraps, seed):
    """Evaluate an LFO waveform at explicit phases (shares the formulas of
    ops/lfo.lfo_block)."""
    import math

    tau = 2.0 * math.pi
    p_sine = jnp.where(phase < 0.5, phase * tau, (phase - 1.0) * tau)
    sine = lfo_ops.sine_approx(p_sine)
    triangle = jnp.where(
        phase < 0.25, phase * 4.0,
        jnp.where(phase < 0.75, 2.0 - phase * 4.0, phase * 4.0 - 4.0),
    )
    ramp_up = phase * 2.0 - 1.0
    ramp_down = 1.0 - phase * 2.0
    square = jnp.where(phase < 0.5, 1.0, -1.0)
    random = lfo_ops._hash_random(seed, wraps)
    t = (1.0 - lfo_ops.sine_approx(math.pi / 2.0 - phase * math.pi)) * 0.5
    smooth = random + t * (lfo_ops._hash_random(seed, wraps + 1) - random)
    stacked = jnp.stack([sine, triangle, ramp_up, ramp_down, square, random, smooth])
    return jnp.take(stacked, jnp.clip(jnp.asarray(wf, jnp.int32), 0, 6), axis=0)


def build_source_specs(config, params, sample_rate):
    """Per-block, voice-independent payloads for each configured source
    (computed once outside the voice vmap).  Returns a list of
    (kind, payload) consumed by ``eval_sources``."""
    from . import config as cfg_mod
    from ..ops import ahdsr as ahdsr_ops

    specs = []
    lfo_slot = 0
    for s in config.sources:
        if isinstance(s, cfg_mod.LfoSource):
            lfo_slot += 1
            inc = params[s.rate_param][0] / sample_rate
            wf = params[s.wave_param][0].astype(jnp.int32)
            specs.append(("lfo", (inc, wf, 0x11 * lfo_slot)))
        elif isinstance(s, cfg_mod.EnvelopeSource):
            p = s.prefix
            e0 = lambda c: params[p + c][0]
            env_p = ahdsr_ops.ahdsr_params(
                sample_rate, e0("A"), e0("H"), e0("D"), e0("S"), e0("R"))
            specs.append(("env", env_p))
        elif isinstance(s, cfg_mod.VelocitySource):
            specs.append(("vel", None))
        elif isinstance(s, cfg_mod.KeytrackingSource):
            specs.append(("key", None))
        else:
            raise TypeError(f"unknown modulation source {s!r}")
    return specs


def eval_sources(specs, age, velocity, note, release_at, n: int, seed: int = 0):
    """[S, n] per-voice source values for an arbitrary config (per-voice
    part, runs under the voice vmap).

    age: int32[n] runs since note-on (handles in-block retriggers);
    release_at: scalar-or-[n] age at note-off (inf = held) for envelopes."""
    from ..ops import ahdsr as ahdsr_ops

    agef = jnp.maximum(age.astype(jnp.float32), 0.0)
    vals = []
    for kind, payload in specs:
        if kind == "lfo":
            inc, wf, salt = payload
            raw = agef * inc
            phase = raw - jnp.floor(raw)
            wraps = jnp.floor(raw).astype(jnp.int32)
            vals.append(_waveform_at(wf, phase, wraps, seed + salt))
        elif kind == "env":
            # envelope scales by the note velocity, like the reference's
            # matrix.note_on(note, volume) (src/modulation/processor.rs:134)
            vals.append(ahdsr_ops.ahdsr_values(payload, velocity, age, release_at))
        elif kind == "vel":
            vals.append(jnp.broadcast_to(jnp.asarray(velocity, jnp.float32), (n,)))
        else:  # key
            vals.append(jnp.broadcast_to(
                jnp.asarray(note, jnp.float32) / 127.0, (n,)))
    return jnp.stack(vals)


def source_polarity(config):
    """[S] 1.0 where the source is bipolar."""
    return np.asarray([1.0 if s.bipolar else 0.0 for s in config.sources],
                      np.float32)


def apply_matrix(sources, amounts, bipolar, src_bipolar=None):
    """sources [S, n] -> target offsets [T, n] with polarity transforms.
    ``src_bipolar``: [S] source polarities (default: the stock
    LFO1/LFO2/VELM/KEYM layout)."""
    if src_bipolar is None:
        src_bipolar = SOURCE_BIPOLAR
    src_bip = jnp.asarray(src_bipolar, jnp.float32)[:, None, None]  # [S,1,1]
    s = sources[:, None, :]  # [S, 1, n]
    tgt_bip = jnp.asarray(bipolar, jnp.float32)[:, :, None]  # [S, T, 1]
    # four polarity cases (matrix.rs:196-246)
    as_is = s
    bi_to_uni = (s + 1.0) * 0.5
    uni_to_bi = (s - 0.5) * 2.0
    v = jnp.where(
        src_bip > 0.5,
        jnp.where(tgt_bip > 0.5, as_is, bi_to_uni),
        jnp.where(tgt_bip > 0.5, uni_to_bi, as_is),
    )
    return jnp.sum(v * jnp.asarray(amounts, jnp.float32)[:, :, None], axis=0)  # [T, n]
