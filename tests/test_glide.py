"""Speed glides (reference: FilePlaybackHandle::set_speed with glide,
src/player/handles/file.rs:150-176 + src/source/file/common.rs:141-163).

The reference ramps speed toward the target at `rate` semitones/second,
recomputing a linear step every 64 frames.  The engine's lowering replays that
recurrence on the host and emits piecewise-linear ramp knots on a 512-frame
grid, so knot values match the reference staircase exactly and the in-block
evaluation stays a vectorized gather.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from phonic_tpu.config import EngineConfig
from phonic_tpu.events import ParamTimeline, GLIDE_CHUNK_FRAMES
from phonic_tpu.graph.engine import RenderProgram, _step_targets
from phonic_tpu.graph.mixer import Mixer
from phonic_tpu.io.decoder import AudioFileBuffer
from phonic_tpu.ops.smoothing import SegmentEvents
from phonic_tpu.sources.file import FilePlaybackOptions, FileSource

SR = 48000


def reference_glide(current, target, rate, sr, frames):
    """Per-frame speed staircase exactly as the reference computes it
    (common.rs:141-163, 64-frame update chunks)."""
    out = np.empty(frames, np.float64)
    c = float(current)
    for k in range(0, frames, GLIDE_CHUNK_FRAMES):
        if abs(target - c) > 1e-4:
            semis = abs(12.0 * np.log2(target / c))
            dur = semis / rate * sr
            step = (target - c) / dur * GLIDE_CHUNK_FRAMES
            c = target if abs(target - c) < abs(step) else c + step
        else:
            c = target
        out[k : k + GLIDE_CHUNK_FRAMES] = c
    return out[:frames]


def test_step_targets_ramp_event():
    n = 256
    k = 4
    times = np.full(k, n, np.int32)
    values = np.zeros(k, np.float32)
    ramps = np.zeros(k, np.float32)
    times[0], values[0], ramps[0] = 100, 2.0, 1.0
    ev = SegmentEvents(jnp.asarray(times), jnp.asarray(values))
    end, vals = _step_targets(jnp.float32(1.0), ev, jnp.asarray(ramps), n)
    vals = np.asarray(vals)
    assert vals[0] == pytest.approx(1.0)
    assert vals[50] == pytest.approx(1.5, abs=1e-5)
    assert vals[100] == pytest.approx(2.0)
    assert vals[-1] == pytest.approx(2.0)
    assert float(end) == pytest.approx(2.0)


def test_timeline_glide_matches_reference_staircase_at_knots():
    tl = ParamTimeline(initial=1.0)
    tl.set_glide_at(0, 2.0, rate=24.0, sample_rate=SR)
    frames = 2 * SR
    ref = reference_glide(1.0, 2.0, 24.0, SR, frames)
    # knot values are exact; between knots the lowering is linear while the
    # reference holds 64-frame steps, so compare at the 512-grid
    for t in range(512, frames, 2048):
        got = tl.value_at(t + 1)  # value in effect at frame t
        assert got == pytest.approx(ref[t], abs=2e-4), t
    # both trajectories converge on the target
    assert tl.value_at(frames) == pytest.approx(2.0, abs=1e-4)
    assert ref[-1] == pytest.approx(2.0, abs=1e-4)


def test_file_playback_glide_end_to_end():
    """Render a position-ramp buffer (data[i] = i) through a glided
    FileSource: the output IS the read position, compared against the
    integral of the reference speed staircase."""
    n = 2048
    cfg = EngineConfig(sample_rate=SR, block_frames=n, batch_sources=False)
    frames = 16 * n  # glide spans 24000 frames from frame 2048
    data = np.tile(np.arange(2 * frames, dtype=np.float32) / SR, (2, 1))
    buf = AudioFileBuffer(data, SR)
    src = FileSource(buf, FilePlaybackOptions(fade_out_secs=0.0))
    m = Mixer()
    m.add_source(src)
    prog = RenderProgram(m, cfg)
    prog.set_parameter(src, "VOLU", 1.0)
    prog.set_parameter_glide(src, "SPED", 2.0, rate=24.0, at_frame=n)
    audio = np.asarray(prog.render(duration_frames=frames, mode="loop"))

    speeds = np.ones(frames, np.float64)
    speeds[n:] = reference_glide(1.0, 2.0, 24.0, SR, frames - n)
    ref_pos = np.concatenate([[0.0], np.cumsum(speeds)[:-1]]) / SR
    got_pos = audio[0].astype(np.float64)
    err = np.abs(got_pos - ref_pos) * SR  # in source frames
    # piecewise-linear knots vs the reference's 64-frame staircase: bounded
    # by a fraction of one update chunk, never accumulating past ~1 ms
    assert err.max() < 48.0, err.max()
    # post-glide slope is exactly the target speed
    tail = got_pos[-n:]
    slope = (tail[-1] - tail[0]) / ((n - 1) / SR)
    assert slope == pytest.approx(2.0, rel=1e-4)


def test_instant_set_speed_unchanged():
    tl = ParamTimeline(initial=1.0)
    tl.set_at(100, 1.5)
    t, v, r = tl.lower_block(0, 256, 4)
    assert t[0] == 100 and v[0] == pytest.approx(1.5) and r[0] == 0.0
    assert tl.value_at(101) == pytest.approx(1.5)
