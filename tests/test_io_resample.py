import struct

import numpy as np
import jax.numpy as jnp
import pytest

from phonic_tpu.io import wav as wav_io
from phonic_tpu.io import AudioFileBuffer, decode_file, file_info
from phonic_tpu.errors import UnsupportedFormatError
from phonic_tpu.ops import resample

import reference_dsp as ref

SR = 48000


def make_tone(frames=4800, channels=2, freq=440.0, sr=SR):
    t = np.arange(frames) / sr
    x = np.stack([0.5 * np.sin(2 * np.pi * freq * t * (c + 1)) for c in range(channels)])
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# WAV I/O
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,float_format,tol", [
    (32, True, 0.0), (16, False, 1 / 32000), (24, False, 1 / 8e6), (32, False, 1e-7),
])
def test_wav_roundtrip(tmp_path, bits, float_format, tol):
    x = make_tone()
    p = tmp_path / "t.wav"
    wav_io.write_wav(p, x, SR, bits=bits, float_format=float_format)
    y, info = wav_io.read_wav(p)
    assert info.sample_rate == SR and info.channels == 2 and info.frames == x.shape[1]
    np.testing.assert_allclose(y, x, atol=max(tol, 1e-9))


def test_wav_smpl_loop_chunk(tmp_path):
    # hand-build a WAV with an smpl loop chunk
    x = make_tone(1000, 1)
    p = tmp_path / "loop.wav"
    wav_io.write_wav(p, x, SR)
    raw = p.read_bytes()
    smpl = struct.pack("<9I", 0, 0, 1000000000 // SR, 60, 0, 0, 0, 1, 0)
    smpl += struct.pack("<6I", 0, wav_io.LOOP_FORWARD, 100, 899, 0, 0)
    chunk = b"smpl" + struct.pack("<I", len(smpl)) + smpl
    new = raw[:4] + struct.pack("<I", len(raw) - 8 + len(chunk)) + raw[8:] + chunk
    p.write_bytes(new)

    buf = AudioFileBuffer.from_file(p)
    assert buf.loop_range == (100, 900)  # inclusive end -> half-open
    assert buf.loop_mode == "forward"
    assert buf.frames == 1000
    assert buf.data.shape == (1, 1001)  # guard frame appended
    assert buf.data[0, -1] == 0.0


def test_unsupported_format_message(tmp_path):
    # ogg/mp3 now decode natively (io/vorbis.py, io/mp3.py); a format with
    # no decoder still names itself and the register_decoder hook
    p = tmp_path / "f.alac"
    p.write_bytes(b"\x00\x01\x02\x03" + b"\x00" * 64)
    with pytest.raises(UnsupportedFormatError, match="alac"):
        decode_file(p)


def test_corrupt_ogg_reports_media_error(tmp_path):
    from phonic_tpu.errors import MediaFileError
    from phonic_tpu.io.vorbis import vorbis_available

    if not vorbis_available():
        pytest.skip("no libvorbisfile")
    p = tmp_path / "f.ogg"
    p.write_bytes(b"OggS" + b"\x00" * 64)
    with pytest.raises(MediaFileError):
        decode_file(p)


def test_corrupt_flac_reports_media_error(tmp_path):
    from phonic_tpu.errors import MediaFileError

    p = tmp_path / "f.flac"
    p.write_bytes(b"fLaC" + b"\x00" * 64)  # garbage metadata
    with pytest.raises(MediaFileError):
        decode_file(p)


def test_file_info_probe(tmp_path):
    x = make_tone(2400)
    p = tmp_path / "t.wav"
    wav_io.write_wav(p, x, SR)
    info = file_info(p)
    assert info.frames == 2400
    assert abs(info.duration_secs - 0.05) < 1e-9


# ---------------------------------------------------------------------------
# Hermite resampling
# ---------------------------------------------------------------------------


def hermite_oracle(buf, positions):
    """NumPy positional oracle of the Niemitalo x-form."""
    out = np.zeros(len(positions), np.float64)
    n = len(buf)
    for j, p in enumerate(positions):
        k = int(np.floor(p))
        f = p - k
        def g(i):
            return buf[i] if 0 <= i < n else 0.0
        ym1, y0, y1, y2 = g(k - 1), g(k), g(k + 1), g(k + 2)
        c0 = y0
        c1 = (y1 - ym1) * 0.5
        c2 = ym1 - y0 * 2.5 + y1 * 2.0 - y2 * 0.5
        c3 = (y2 - ym1) * 0.5 + (y0 - y1) * 1.5
        out[j] = ((c3 * f + c2) * f + c1) * f + c0
    return out


def test_hermite_read_matches_oracle():
    rng = np.random.default_rng(3)
    buf = rng.normal(size=256).astype(np.float32)
    pos = np.sort(rng.uniform(-2, 258, 512)).astype(np.float32)
    got = np.asarray(resample.hermite_read(jnp.asarray(buf), jnp.asarray(pos)))
    expected = hermite_oracle(buf, pos)
    np.testing.assert_allclose(got, expected, atol=1e-5)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("frames", [127, 256, 391])
def test_hermite_read_mm_matches_hermite_read(channels, frames):
    """The gather-free one-hot formulation must agree with the gather path for
    odd lengths, out-of-range positions (negative / past-end), and both
    channel layouts (ADVICE r3: all three playback paths depend on it)."""
    rng = np.random.default_rng(7)
    buf = rng.normal(size=(channels, frames)).astype(np.float32)
    pos = np.concatenate([
        np.sort(rng.uniform(-6, frames + 6, 300)),
        np.array([-4.0, -1.0, -0.5, 0.0, frames - 1.0, frames - 0.5,
                  float(frames), frames + 3.0]),
    ]).astype(np.float32)
    want = np.asarray(resample.hermite_read(jnp.asarray(buf), jnp.asarray(pos)))
    packed = resample.mm_pack(buf)
    got = np.asarray(resample.hermite_read_mm(jnp.asarray(packed),
                                              jnp.asarray(pos), chunk=64))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_hermite_read_mm_under_vmap():
    import jax
    rng = np.random.default_rng(11)
    lanes, frames = 3, 200
    bufs = rng.normal(size=(lanes, 1, frames)).astype(np.float32)
    pos = rng.uniform(-3, frames + 3, (lanes, 128)).astype(np.float32)
    packed = np.stack([resample.mm_pack(b) for b in bufs])
    got = np.asarray(jax.vmap(
        lambda b, p: resample.hermite_read_mm(b, p, chunk=64))(
            jnp.asarray(packed), jnp.asarray(pos)))
    want = np.stack([
        np.asarray(resample.hermite_read(jnp.asarray(bufs[i]),
                                         jnp.asarray(pos[i])))
        for i in range(lanes)])
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_use_mm_threshold():
    assert resample.use_mm(48000)
    assert not resample.use_mm(resample.MM_MAX_ROWS * 128 + 1)
    # boundary: exactly at the threshold row count still uses mm
    f_edge = ((resample.MM_MAX_ROWS - 1) * resample.MM_STRIDE
              - resample.MM_PAD_LEFT - 3)
    assert resample.use_mm(f_edge)
    assert not resample.use_mm(f_edge + 1)


def test_long_buffer_file_source_matches_short_path():
    """A FileSource over the rs.use_mm threshold renders through the planar
    gather; its output must match the mm path bit-for-bit where both read
    the same samples (same DSP, different read kernel: tolerance 2e-5)."""
    import jax
    from phonic_tpu import (EngineConfig, FilePlaybackOptions, FileSource,
                            Mixer, RenderProgram)
    frames = (resample.MM_MAX_ROWS + 4) * 128  # above threshold
    rng = np.random.default_rng(5)
    sig = (0.2 * rng.normal(size=frames)).astype(np.float32)
    long_buf = AudioFileBuffer.from_array(sig[None, :], 48000)
    src = FileSource(long_buf, FilePlaybackOptions(speed=1.31, repeat=None,
                                                   fade_out_secs=0.0))
    assert not resample.use_mm(long_buf.frames)
    m = Mixer("main")
    m.add_source(src)
    prog = RenderProgram(m, EngineConfig(sample_rate=48000, block_frames=512))
    st = prog.init_state()
    st, audio = prog.step_packed(st, prog.packed_block_inputs(0))
    got = np.asarray(audio)[0]
    pos = (np.arange(512) * 1.31).astype(np.float32)
    want = hermite_oracle(sig.astype(np.float64), pos)
    # volume 1, centre pan (unity), mono->stereo duplication: gain 1.0
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_hermite_exact_at_integers():
    buf = np.arange(32, dtype=np.float32)
    pos = jnp.arange(1, 30, dtype=jnp.float32)
    got = np.asarray(resample.hermite_read(jnp.asarray(buf), pos))
    np.testing.assert_allclose(got, np.arange(1, 30), atol=1e-6)


def test_resample_energy_and_length():
    # mirrors the reference's own resampling unit test approach
    # (src/source/file/preloaded.rs:480-534): length ratio + energy conservation
    sr_in, sr_out = 44100, 48000
    t = np.arange(sr_in) / sr_in
    x = np.sin(2 * np.pi * 440 * t).astype(np.float32)
    ratio = sr_in / sr_out
    n_out = int(len(x) / ratio) - 4
    pos = resample.resample_positions(n_out, ratio)
    y = np.asarray(resample.hermite_read(jnp.asarray(x), pos))
    rms_in = np.sqrt(np.mean(x**2))
    rms_out = np.sqrt(np.mean(y**2))
    assert abs(rms_in - rms_out) / rms_in < 0.01


def test_sinc_read_better_than_hermite_on_downsample():
    # 2x downsample of a tone near the new nyquist: sinc must suppress the alias
    sr_in = 96000
    t = np.arange(sr_in // 4) / sr_in
    f = 30000.0  # above 48k nyquist -> must vanish after AA filtering
    x = np.sin(2 * np.pi * f * t).astype(np.float32)
    pos = resample.resample_positions(len(x) // 2 - 32, 2.0, pos0=16.0)
    table = resample.sinc_table(taps=32, phases=256, cutoff=0.5)
    y_sinc = np.asarray(resample.sinc_read(jnp.asarray(x), pos, table))
    y_herm = np.asarray(resample.hermite_read(jnp.asarray(x), pos))
    assert np.sqrt(np.mean(y_sinc**2)) < 0.02  # alias killed
    assert np.sqrt(np.mean(y_herm**2)) > 0.1  # hermite aliases (expected)


def test_sinc_passband_accuracy():
    sr_in = 44100
    t = np.arange(8192) / sr_in
    x = np.sin(2 * np.pi * 1000 * t).astype(np.float32)
    ratio = 44100 / 48000
    n_out = int(len(x) / ratio) - 64
    pos = resample.resample_positions(n_out, ratio, pos0=32.0)
    table = resample.sinc_table()
    y = np.asarray(resample.sinc_read(jnp.asarray(x), pos, table))
    t_out = (np.asarray(pos)) / sr_in
    expected = np.sin(2 * np.pi * 1000 * t_out)
    err = ref.error_db(y, expected, ref_peak=1.0)
    assert err < -60.0, f"sinc passband err {err:.1f} dB"


def test_glide_positions():
    steps = jnp.concatenate([jnp.full((100,), 1.0), jnp.full((100,), 2.0)])
    pos, end = resample.glide_positions(steps, pos0=5.0)
    assert float(pos[0]) == 5.0
    assert float(pos[100]) == 105.0
    assert float(end) == 305.0


def test_loop_fold_forward_and_pingpong():
    pos = jnp.arange(0, 40, dtype=jnp.float32)
    fwd = np.asarray(resample.loop_fold(pos, 10, 20, "forward"))
    np.testing.assert_allclose(fwd[:20], np.arange(20))  # pre-loop + first pass
    np.testing.assert_allclose(fwd[20:30], np.arange(10, 20))  # wrapped
    pp = np.asarray(resample.loop_fold(pos, 10, 20, "pingpong"))
    np.testing.assert_allclose(pp[20:30], np.arange(20, 10, -1))  # reflected


# ---------------------------------------------------------------------------
# Two-stage two-window read (hermite_read_mm2)
# ---------------------------------------------------------------------------


def _ramp_positions(rng, frames, n, smax, fold=None):
    """Bounded-step ramp with optional mod-folds (the mm2 contract)."""
    steps = rng.uniform(0.1, smax * 0.98, n).astype(np.float32)
    pos = 8.0 + np.cumsum(steps)
    if fold == "circular":
        pos = np.mod(pos, frames)
    elif fold == "loop":
        ls, le = frames * 0.25, frames * 0.75
        pos = np.where(pos >= ls, ls + np.mod(pos - ls, le - ls), pos)
    elif fold == "shortloop":
        ls, le = frames * 0.4, frames * 0.4 + 97.0  # many folds per chunk
        pos = np.where(pos >= ls, ls + np.mod(pos - ls, le - ls), pos)
    elif fold == "pingpong":
        ls, le = frames * 0.3, frames * 0.8
        length = le - ls
        c = np.mod(pos - ls, 2 * length)
        pos = np.where(pos < ls, pos,
                       ls + np.where(c < length, c, 2 * length - c))
    return pos.astype(np.float32)


@pytest.mark.parametrize("fold", [None, "circular", "loop", "shortloop",
                                  "pingpong"])
@pytest.mark.parametrize("smax", [1.0, 4.0])
def test_hermite_read_mm2_matches_hermite_read(fold, smax):
    rng = np.random.default_rng(19)
    frames = 9000
    buf = rng.normal(size=(2, frames)).astype(np.float32)
    pos = _ramp_positions(rng, frames, 2600, smax, fold)
    want = np.asarray(resample.hermite_read(jnp.asarray(buf), jnp.asarray(pos)))
    packed = resample.mm_pack(buf)
    got = np.asarray(resample.hermite_read_mm2(
        jnp.asarray(packed), jnp.asarray(pos), smax=smax, chunk=512))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_hermite_read_mm2_out_of_range_and_small_buffer():
    rng = np.random.default_rng(23)
    frames = 5000
    buf = rng.normal(size=(1, frames)).astype(np.float32)
    # ramp running past the end and a stale cluster clamped at one boundary
    steps = rng.uniform(0.0, 2.0, 1500).astype(np.float32)
    pos = (frames - 900.0) + np.cumsum(steps)
    pos = np.concatenate([np.full(64, -50.0, np.float32), pos.astype(np.float32)])
    want = np.asarray(resample.hermite_read(jnp.asarray(buf), jnp.asarray(pos)))
    packed = resample.mm_pack(buf)
    got = np.asarray(resample.hermite_read_mm2(
        jnp.asarray(packed), jnp.asarray(pos), smax=2.0, chunk=512))
    np.testing.assert_allclose(got, want, atol=2e-5)
    # tiny buffer: falls back to the single-window read internally
    small = rng.normal(size=(1, 300)).astype(np.float32)
    spos = _ramp_positions(rng, 300, 700, 1.0, "circular")
    want_s = np.asarray(resample.hermite_read(jnp.asarray(small),
                                              jnp.asarray(spos)))
    got_s = np.asarray(resample.hermite_read_mm2(
        jnp.asarray(resample.mm_pack(small)), jnp.asarray(spos), smax=1.0,
        chunk=512))
    np.testing.assert_allclose(got_s, want_s, atol=2e-5)


def test_hermite_read_mm2_under_vmap():
    import jax
    rng = np.random.default_rng(29)
    lanes, frames = 3, 8000
    bufs = rng.normal(size=(lanes, 1, frames)).astype(np.float32)
    pos = np.stack([_ramp_positions(rng, frames, 1024, 2.0, f)
                    for f in (None, "circular", "loop")])
    packed = np.stack([resample.mm_pack(b) for b in bufs])
    got = np.asarray(jax.vmap(
        lambda b, p: resample.hermite_read_mm2(b, p, smax=2.0, chunk=256))(
            jnp.asarray(packed), jnp.asarray(pos)))
    want = np.stack([
        np.asarray(resample.hermite_read(jnp.asarray(bufs[i]),
                                         jnp.asarray(pos[i])))
        for i in range(lanes)])
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_speed_bucket():
    assert resample.speed_bucket(0.5) == 0
    assert resample.speed_bucket(1.0) == 0
    assert resample.speed_bucket(2.0) == 1
    assert resample.speed_bucket(1.5) == 1
    assert resample.speed_bucket(3.9) == 2
    assert resample.speed_bucket(100.0) == 6  # capped
