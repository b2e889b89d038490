"""Batched file-source lane banks must match the unbatched path exactly."""

import dataclasses

import numpy as np

from phonic_tpu import (AudioFileBuffer, EngineConfig, FilePlaybackOptions,
                        FileSource, Mixer, RenderProgram)

SR = 48000


def build(batch: bool, seed=0):
    rng = np.random.default_rng(seed)
    main = Mixer("main")
    subs = [main.add_mixer(Mixer(f"s{i}")) for i in range(2)]
    srcs = []
    for i in range(6):
        frames = 4000 + 700 * i
        t = np.arange(frames) / 44100
        x = (0.4 * np.sin(2 * np.pi * (100 + 60 * i) * t)).astype(np.float32)
        buf = AudioFileBuffer.from_array(x[None, :], 44100)
        src = FileSource(buf, FilePlaybackOptions(
            volume=float(rng.uniform(0.3, 0.9)),
            panning=float(rng.uniform(-0.8, 0.8)),
            speed=float(rng.uniform(0.6, 1.8)),
            start_time=int(rng.integers(0, 2000)),
            repeat=None,
        ), name=f"src{i}")
        subs[i % 2].add_source(src)
        srcs.append(src)
    cfg = EngineConfig(sample_rate=SR, block_frames=2048, batch_sources=batch)
    prog = RenderProgram(main, cfg)
    return prog, srcs


def test_batched_equals_unbatched():
    pa, sa = build(True)
    pb, sb = build(False)
    assert pa.file_batches, "expected at least one batch group"
    # schedule identical automation + stops on both
    for prog, srcs in ((pa, sa), (pb, sb)):
        prog.set_parameter(srcs[0], "VOLU", 0.2, at_frame=3000)
        prog.set_parameter(srcs[2], "SPED", 1.3, at_frame=5000)
        prog.set_parameter(srcs[4], "PANN", -1.0, at_frame=1000)
        prog.stop_source(srcs[1], at_frame=6000)
        prog.stop_source(srcs[3], at_frame=4000, kill=True)
        srcs[5].seek(4096, 1500.0)
    a = pa.render(duration_frames=12288)
    b = pb.render(duration_frames=12288)
    np.testing.assert_allclose(a, b, atol=2e-6)


def test_batched_loops_and_repeats():
    def make(batch):
        main = Mixer("main")
        for i in range(3):
            x = np.linspace(0, 1, 1000 + i * 100, dtype=np.float32)
            buf = AudioFileBuffer.from_array(
                x[None, :], SR, loop_range=(100, 800 + i * 50))
            main.add_source(FileSource(buf, FilePlaybackOptions(
                repeat=None, fade_out_secs=0.0), name=f"l{i}"))
        cfg = EngineConfig(sample_rate=SR, block_frames=1024, batch_sources=batch)
        return RenderProgram(main, cfg)
    a = make(True).render(duration_frames=8192)
    b = make(False).render(duration_frames=8192)
    np.testing.assert_allclose(a, b, atol=2e-6)


def _force_gather(prog):
    """Flip every file batch to the plain planar gather read, so the
    default one-hot mm2 read is pinned to it end-to-end."""
    assert prog.file_batches
    for fb in prog.file_batches.values():
        assert fb.mode == "mm2"
        fb.mode = "gather"
    return prog


def test_batched_gather_read_matches_mm2():
    pa, sa = build(True, seed=1)
    pb, _ = build(True, seed=1)
    _force_gather(pb)
    a = pa.render(duration_frames=6144)
    b = pb.render(duration_frames=6144)
    np.testing.assert_allclose(a, b, atol=2e-6)


def test_batched_gather_read_loops():
    def make(batch, force):
        main = Mixer("main")
        for i in range(3):
            x = np.linspace(0, 1, 1000 + i * 100, dtype=np.float32)
            buf = AudioFileBuffer.from_array(
                x[None, :], SR, loop_range=(100, 800 + i * 50))
            main.add_source(FileSource(buf, FilePlaybackOptions(
                repeat=None, fade_out_secs=0.0,
                speed=1.0 + 0.37 * i), name=f"l{i}"))
        cfg = EngineConfig(sample_rate=SR, block_frames=1024,
                           batch_sources=batch)
        prog = RenderProgram(main, cfg)
        return _force_gather(prog) if force else prog
    a = make(True, True).render(duration_frames=4096)
    b = make(True, False).render(duration_frames=4096)
    np.testing.assert_allclose(a, b, atol=2e-6)


def test_adopt_carries_batched_effect_state():
    """Topology edits must carry batched effect-chain lane states (delay
    rings keep ringing through an adopt), covering RenderProgram.adopt's
    effect_batches transfer in both directions."""
    import dataclasses

    from phonic_tpu import EngineConfig, FilePlaybackOptions, FileSource, Mixer, RenderProgram
    from phonic_tpu.effects.delay import DelayEffect
    from phonic_tpu.effects.gain import GainEffect
    from phonic_tpu.io.decoder import AudioFileBuffer

    SR = 48000

    def build(extra_effect):
        t = np.arange(6000) / SR
        main = Mixer("main")
        subs = [main.add_mixer(Mixer(f"s{i}")) for i in range(2)]
        for i, s in enumerate(subs):
            tone = (0.5 * np.sin(2 * np.pi * (220 + 110 * i) * t)).astype(np.float32)
            s.add_source(FileSource(
                AudioFileBuffer.from_array(tone[None, :], SR),
                FilePlaybackOptions(fade_out_secs=0.0), name=f"src{i}"))
            s.add_effect(DelayEffect(delay_ms=80.0, feedback=0.5, wet=0.8,
                                     name=f"d{i}"))
        if extra_effect:
            main.add_effect(GainEffect(gain=1.0, name="master2"))
        return main

    cfg = EngineConfig(sample_rate=SR, block_frames=2048)
    root = build(False)
    prog1 = RenderProgram(root, cfg)
    assert prog1.effect_batches, "expected a 2-lane delay batch"
    state = prog1.init_state()
    for b in range(4):  # tone ends at 6000; delay tail keeps ringing
        state, y = prog1._jit_step(state, prog1.block_inputs(b))

    # topology edit: add a master effect -> rebuild + adopt
    root.add_effect(GainEffect(gain=1.0, name="master2"))
    prog2 = RenderProgram(root, cfg)
    assert prog2.effect_batches
    state2 = prog2.adopt(prog1, state)
    state2, y2 = prog2._jit_step(state2, prog2.block_inputs(4))
    tail = float(np.abs(np.asarray(y2)).max())
    assert tail > 1e-4, "delay tail lost across adopt"

    # and the carried tail matches rendering without the edit
    state, y_ref = prog1._jit_step(state, prog1.block_inputs(4))
    np.testing.assert_allclose(np.asarray(y2), np.asarray(y_ref), atol=1e-6)
