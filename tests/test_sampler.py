"""Sampler generator: voice allocation, AHDSR voices, steal policy."""

import math

import numpy as np
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.slow

from phonic_tpu import AudioFileBuffer, EngineConfig, Mixer, RenderProgram
from phonic_tpu.generators.base import GeneratorPlaybackOptions
from phonic_tpu.generators.sampler import AhdsrConfig, Sampler

import reference_dsp as ref

SR = 48000
CFG = EngineConfig(sample_rate=SR, channels=2, block_frames=2048, max_events_per_block=8)


def tone_buffer(frames=48000, freq=440.0):
    t = np.arange(frames) / SR
    x = (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
    return AudioFileBuffer.from_array(x[None, :], SR)


def make_prog(sampler):
    main = Mixer("main")
    main.add_source(sampler)
    return RenderProgram(main, CFG)


def test_single_note_matches_composition():
    buf = tone_buffer()
    s = Sampler(buf, envelope=AhdsrConfig(attack=0.01, release=0.1))
    nid = s.note_on(60, volume=0.8, time=1000)
    s.note_off(nid, time=20000)
    prog = make_prog(s)
    out = prog.render(duration_frames=32000)

    # oracle: buffer read at speed 1 from frame 1000, AHDSR applied
    env = ref.Ahdsr(SR, 0.01, 0.0, 0.0, 1.0, 0.1)
    env.note_on(1.0)
    expected = np.zeros((2, 32000))
    mono = np.asarray(buf.data[0], np.float64)
    for i in range(1000, 32000):
        age = i - 1000
        if i == 20000:
            env.note_off()
        e = env.run()
        v = mono[age] if age < buf.frames else 0.0
        expected[:, i] = v * e * 0.8
    err = ref.error_db(out, expected, ref_peak=np.max(np.abs(expected)))
    assert err < -70.0, f"sampler note err {err:.1f} dB"
    assert np.max(np.abs(out[:, :1000])) == 0.0
    # released and decayed
    assert np.max(np.abs(out[:, 26000:])) < 1e-3


def test_note_pitch_tracking():
    buf = tone_buffer(freq=440.0)
    s = Sampler(buf, envelope=AhdsrConfig(attack=0.0, release=0.05))
    nid = s.note_on(72)  # +1 octave -> 880 Hz
    s.note_off(nid, time=9600)
    prog = make_prog(s)
    out = prog.render(duration_frames=12288)
    seg = out[0, 2048:8192]
    # zero-crossing rate ~ 880 Hz
    zc = np.sum(np.abs(np.diff(np.signbit(seg))))
    freq = zc / 2 * SR / len(seg)
    assert abs(freq - 880.0) < 15.0, freq


def test_transpose_and_finetune():
    buf = tone_buffer()
    s = Sampler(buf, envelope=AhdsrConfig(attack=0.0, release=0.05),
                transpose=12)
    nid = s.note_on(60)
    s.note_off(nid, time=9600)
    out = make_prog(s).render(duration_frames=12288)
    seg = out[0, 2048:8192]
    zc = np.sum(np.abs(np.diff(np.signbit(seg))))
    freq = zc / 2 * SR / len(seg)
    assert abs(freq - 880.0) < 15.0, freq


def test_polyphony_sums_voices():
    buf = tone_buffer()
    s = Sampler(buf, envelope=AhdsrConfig(attack=0.0, release=0.05))
    a = s.note_on(60, volume=0.5, time=0)
    b = s.note_on(67, volume=0.5, time=0)
    s.note_off(a, time=9600)
    s.note_off(b, time=9600)
    out = make_prog(s).render(duration_frames=12288)

    s1 = Sampler(buf, envelope=AhdsrConfig(attack=0.0, release=0.05))
    n1 = s1.note_on(60, volume=0.5)
    s1.note_off(n1, time=9600)
    out1 = make_prog(s1).render(duration_frames=12288)

    s2 = Sampler(buf, envelope=AhdsrConfig(attack=0.0, release=0.05))
    n2 = s2.note_on(67, volume=0.5)
    s2.note_off(n2, time=9600)
    out2 = make_prog(s2).render(duration_frames=12288)

    np.testing.assert_allclose(out, out1 + out2, atol=1e-5)


def test_voice_stealing_oldest():
    # 2 voices, 3 overlapping notes: the third steals the oldest mid-block
    buf = tone_buffer()
    s = Sampler(buf, GeneratorPlaybackOptions(voices=2),
                envelope=AhdsrConfig(attack=0.0, release=0.2))
    s.note_on(60, time=0)
    s.note_on(64, time=100)
    s.note_on(67, time=5000)  # steals voice of note 60
    s.all_notes_off(time=12000)
    out = make_prog(s).render(duration_frames=24576)
    assert np.max(np.abs(out[:, :5000])) > 0.1
    assert np.max(np.abs(out[:, 5000:12000])) > 0.1
    # after release everything decays
    assert np.max(np.abs(out[:, 23000:])) < 2e-3

    voices = s._allocate(SR)
    segs = [seg for v in voices for seg in v]
    assert len(segs) == 3
    cut = [seg for seg in segs if seg.cut is not math.inf]
    assert len(cut) == 1 and cut[0].note == 60 and cut[0].cut == 5000


def test_steal_prefers_releasing_voice():
    buf = tone_buffer()
    s = Sampler(buf, GeneratorPlaybackOptions(voices=2),
                envelope=AhdsrConfig(attack=0.0, release=1.0))
    a = s.note_on(60, time=0)
    b = s.note_on(64, time=0)
    s.note_off(a, time=1000)  # a is releasing
    s.note_on(67, time=2000)  # must steal a's voice (releasing), not b
    voices = s._allocate(SR)
    for v in voices:
        notes = [seg.note for seg in v]
        if 60 in notes:
            assert 67 in notes  # 67 landed on 60's voice
        if 64 in notes:
            assert len(v) == 1


def test_no_envelope_one_shot():
    buf = tone_buffer(frames=4800)
    s = Sampler(buf)  # no envelope: plays to buffer end
    s.note_on(60)
    prog = make_prog(s)
    dur = prog.natural_duration_frames()
    assert dur is not None and abs(dur - 4800) < 16
    out = prog.render()
    assert np.max(np.abs(out[:, :4000])) > 0.1


def test_mm2_read_matches_gather(monkeypatch):
    """The one-hot mm2 voice read must match the plain gather read through
    a full multi-note render, including a loop range and pitched notes
    (read-window fold contract)."""
    import phonic_tpu.generators.sampler as smod

    def build(mm2):
        monkeypatch.setattr(smod.rs, "use_mm2", lambda frames: mm2)
        buf = tone_buffer(frames=9000)
        s = Sampler(buf, GeneratorPlaybackOptions(voices=3),
                    envelope=AhdsrConfig(attack=0.005, release=0.05))
        s.set_loop_range((500, 7500), time=0)
        a = s.note_on(60, volume=0.8, time=100)
        b = s.note_on(67, volume=0.6, time=900)
        c = s.note_on(53, volume=0.7, time=2500)
        s.note_off(a, time=4000)
        s.note_off(b, time=6000)
        s.note_off(c, time=7000)
        prog = make_prog(s)
        return prog.render(duration_frames=8192)

    a = build(True)
    b = build(False)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=3e-6)
