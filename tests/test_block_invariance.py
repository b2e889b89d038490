"""Cross-block-size invariance: the same graph rendered at different block
sizes must agree within a documented bound.

The engine's math is block-size independent by construction (closed-form
smoothers, analytic envelopes, sub-block feedback decomposition), but f32
scan reassociation drifts ~-70 dB in the worst feedback chains (PARITY.md §2.9).
This quantifies that seam per effect family and pins the bound so a
regression (a genuinely block-dependent code path) fails loudly.  The f64
strict-parity mode must agree to near round-off."""

import numpy as np
import pytest

from phonic_tpu import (AudioFileBuffer, EngineConfig, FilePlaybackOptions,
                        FileSource, Mixer, RenderProgram)
from phonic_tpu.effects.chorus import ChorusEffect
from phonic_tpu.effects.compressor import CompressorEffect
from phonic_tpu.effects.delay import DelayEffect
from phonic_tpu.effects.eq5 import Eq5Effect
from phonic_tpu.effects.reverb import ReverbEffect

SR = 48000
FRAMES = 32768


def tone_buffer():
    t = np.arange(FRAMES) / SR
    x = (0.5 * np.sin(2 * np.pi * 220 * t) * np.exp(-t * 1.5)
         + 0.2 * np.sin(2 * np.pi * 733 * t)).astype(np.float32)
    return AudioFileBuffer.from_array(x[None, :], SR)


def render(effects, block, dtype=None):
    m = Mixer("main")
    m.add_source(FileSource(tone_buffer(), FilePlaybackOptions(
        volume=0.8, fade_out_secs=0.0)))
    for e in effects():
        m.add_effect(e)
    kw = {} if dtype is None else {"scan_dtype": dtype}
    prog = RenderProgram(m, EngineConfig(
        sample_rate=SR, channels=2, block_frames=block,
        max_events_per_block=8, **kw))
    return np.asarray(prog.render(duration_frames=FRAMES), np.float64)


def err_db(a, b):
    ref = np.max(np.abs(b)) or 1.0
    return 20.0 * np.log10(max(np.max(np.abs(a - b)) / ref, 1e-30))


# documented bounds (f32 scan reassociation; see PARITY.md §2.9)
CASES = [
    ("stateless", lambda: [Eq5Effect(gains=[3, -2, 1, -4, 2])], -80.0),
    ("compressor", lambda: [CompressorEffect(threshold=-18.0, ratio=4.0)], -60.0),
    ("delay", lambda: [DelayEffect(delay_ms=125.0, feedback=0.5, wet=0.4)], -60.0),
    ("chorus", lambda: [ChorusEffect(rate=0.8, depth=0.7, wet=0.5)], -60.0),
    ("reverb", lambda: [ReverbEffect(room_size=0.7, wet=0.4)], -55.0),
]


@pytest.mark.slow
@pytest.mark.parametrize("name,effects,bound", CASES)
def test_block_size_invariance_f32(name, effects, bound):
    a = render(effects, 2048)
    b = render(effects, 8192)
    e = err_db(a, b)
    assert e < bound, f"{name}: 2048-vs-8192 drift {e:.1f} dB (bound {bound})"


@pytest.mark.slow
def test_block_size_invariance_f64_strict():
    """In strict mode the reassociation seam collapses to round-off."""
    effects = lambda: [CompressorEffect(threshold=-18.0, ratio=4.0),
                       ReverbEffect(room_size=0.7, wet=0.3)]
    a = render(effects, 2048, dtype="float64")
    b = render(effects, 8192, dtype="float64")
    e = err_db(a, b)
    assert e < -90.0, f"f64 strict drift {e:.1f} dB"
