"""Benchmark: audio-seconds rendered per second at 48 kHz stereo on one GPU.

Renders each config below through the production stepping path on the
default JAX device, which must be a GPU, and prints ONE JSON line: the
headline (the 16-source mixer graph with full effect chains, BASELINE
config 3) plus every config's x-real-time figure, with the device it ran
on.  Per-config progress goes to stderr.  A config that fails makes the run
exit non-zero.

    python bench.py
"""

import json
import sys
import time

import numpy as np


def _mk_config(block_frames):
    from phonic_tpu import EngineConfig
    return EngineConfig(sample_rate=48000, block_frames=block_frames)


def _tone(frames=48000, freq=220.0, sr=48000, decay=2.0):
    from phonic_tpu import AudioFileBuffer
    t = np.arange(frames) / sr
    x = (0.5 * np.sin(2 * np.pi * freq * t) * np.exp(-t * decay)).astype(np.float32)
    return AudioFileBuffer.from_array(x[None, :], sr)


def config_play_file():
    """1: single WAV -> gain+pan+resample -> offline render."""
    from phonic_tpu import FilePlaybackOptions, FileSource, Mixer, RenderProgram
    m = Mixer("main")
    m.add_source(FileSource(_tone(sr=48000), FilePlaybackOptions(
        volume=0.8, panning=0.2, speed=1.09, repeat=None)))
    return RenderProgram(m, _mk_config(262144))


def config_sampler_64():
    """2: 64-voice Sampler with AHDSR envelopes."""
    from phonic_tpu import AhdsrConfig, Mixer, RenderProgram, Sampler
    from phonic_tpu.generators.base import GeneratorPlaybackOptions
    m = Mixer("main")
    s = Sampler(_tone(), GeneratorPlaybackOptions(voices=64),
                envelope=AhdsrConfig(attack=0.01, decay=0.3, sustain=0.6,
                                     release=0.4))
    rng = np.random.default_rng(0)
    for k in range(64):
        t = int(k * 480)
        nid = s.note_on(int(rng.integers(36, 84)), float(rng.uniform(0.4, 1.0)),
                        time=t)
        s.note_off(nid, time=t + 400000)  # held across the bench window
    m.add_source(s)
    return RenderProgram(m, _mk_config(131072))


def config_mixer_graph(reverb=True):
    """3 (headline): 16 file sources -> 4 sub-mixers with EQ5+chorus+reverb
    (``reverb=False`` leaves the master reverb out)."""
    from phonic_tpu import FilePlaybackOptions, FileSource, Mixer, RenderProgram
    from phonic_tpu.effects.eq5 import Eq5Effect
    from phonic_tpu.effects.chorus import ChorusEffect
    from phonic_tpu.effects.reverb import ReverbEffect
    from phonic_tpu.effects.gain import GainEffect
    rng = np.random.default_rng(0)
    main = Mixer("main")
    subs = [main.add_mixer(Mixer(f"sub{i}")) for i in range(4)]
    for i in range(16):
        buf = _tone(frames=12000 + 977 * i, freq=float(rng.uniform(80, 660)))
        subs[i % 4].add_source(FileSource(buf, FilePlaybackOptions(
            volume=float(rng.uniform(0.2, 0.6)),
            panning=float(rng.uniform(-0.8, 0.8)),
            speed=float(rng.uniform(0.5, 2.0)), repeat=None)))
    for s in subs:
        s.add_effect(Eq5Effect(gains=list(rng.uniform(-6, 6, 5))))
        s.add_effect(ChorusEffect(rate=float(rng.uniform(0.3, 2.0))))
    # room-size floor/ceiling hints (documented capacity API): this graph
    # never automates the room, so feedback sub-blocks double
    if reverb:
        main.add_effect(ReverbEffect(room_size=0.6, wet=0.2,
                                     min_room_size=0.55))
    main.add_effect(GainEffect(gain=0.8))
    # 131072-frame blocks: scans and dispatch amortize (offline throughput
    # shape; the Player uses small blocks for control latency instead)
    return RenderProgram(main, _mk_config(131072))


def config_granular_1k():
    """4: ~1k concurrent grains with per-grain envelopes."""
    from phonic_tpu import GranularConfig, Mixer, RenderProgram, Sampler
    from phonic_tpu.generators.base import GeneratorPlaybackOptions
    m = Mixer("main")
    # 10 voices x 100-grain pools, sized/densified so pools stay full
    s = Sampler(_tone(frames=96000), GeneratorPlaybackOptions(voices=10)) \
        .with_granular_playback(GranularConfig(
            size_ms=1000.0, density_hz=100.0, position=0.3, variation=0.5,
            spray=0.3, pan_spread=0.8))
    for v in range(10):
        s.note_on(48 + v, volume=0.3, time=v * 37)
    m.add_source(s)
    return RenderProgram(m, _mk_config(131072))


def config_mastering():
    """5: mastering chain on stems: gate + compressor/limiter + delay +
    distortion."""
    from phonic_tpu import FilePlaybackOptions, FileSource, Mixer, RenderProgram
    from phonic_tpu.effects.gate import GateEffect
    from phonic_tpu.effects.compressor import CompressorEffect
    from phonic_tpu.effects.delay import DelayEffect
    from phonic_tpu.effects.distortion import DistortionEffect
    rng = np.random.default_rng(0)
    m = Mixer("main")
    for i in range(4):
        m.add_source(FileSource(_tone(freq=float(rng.uniform(100, 500))),
                                FilePlaybackOptions(volume=0.4, repeat=None)))
    m.add_effect(GateEffect(threshold=-40.0))
    m.add_effect(CompressorEffect(threshold=-12.0, ratio=4.0))
    # hints (documented DelayEffect API): this chain never automates the
    # delay below 250 ms or above 1 s, so the line stays small and the
    # feedback sub-block large (fewer recurrence-scan steps)
    m.add_effect(DelayEffect(delay_ms=300.0, feedback=0.4, wet=0.3,
                             min_delay_ms=250.0,
                             max_delay_capacity_ms=1000.0))
    m.add_effect(DistortionEffect("Diode", drive=1.0, mix=0.3))
    m.add_effect(CompressorEffect.limiter())
    return RenderProgram(m, _mk_config(131072))


def config_player_rt(reverb=True):
    """3b: the SAME 16-source graph in the shape the Player actually runs
    live: 8192-frame blocks, per-mixer metering, auto-bypass ON, blocks
    pulled one at a time through Player.render_block (host bookkeeping,
    packed transfers and device sync included).  ``reverb=False`` leaves
    the master reverb out."""
    from phonic_tpu import FilePlaybackOptions, Player, PlayerConfig
    from phonic_tpu.effects.eq5 import Eq5Effect
    from phonic_tpu.effects.chorus import ChorusEffect
    from phonic_tpu.effects.reverb import ReverbEffect
    from phonic_tpu.outputs.null import NullOutput
    rng = np.random.default_rng(0)
    player = Player(NullOutput(48000, 2), PlayerConfig(block_frames=8192))
    subs = [player.add_mixer() for _ in range(4)]
    for i in range(16):
        buf = _tone(frames=12000 + 977 * i, freq=float(rng.uniform(80, 660)))
        player.play_file(buf, FilePlaybackOptions(
            volume=float(rng.uniform(0.2, 0.6)),
            panning=float(rng.uniform(-0.8, 0.8)),
            speed=float(rng.uniform(0.5, 2.0)), repeat=None),
            mixer=subs[i % 4].mixer)
    for s in subs:
        s.add_effect(Eq5Effect(gains=list(rng.uniform(-6, 6, 5))))
        s.add_effect(ChorusEffect(rate=float(rng.uniform(0.3, 2.0))))
    if reverb:
        player.add_effect(ReverbEffect(room_size=0.6, wet=0.2))
    return player


CONFIGS = {
    "mixer_graph_16src": config_mixer_graph,
    "granular_1k": config_granular_1k,
    "mastering_chain": config_mastering,
    "player_rt_8192": config_player_rt,
    "play_file": config_play_file,
    "sampler_64v": config_sampler_64,
}

HEADLINE = "mixer_graph_16src"


def bench_program(prog, min_iters=10, min_secs=1.0):
    """Steady x real time of ``prog`` (a RenderProgram or a live Player),
    after one warm-up block."""
    import jax
    if hasattr(prog, "render_block"):  # a live Player (realtime shape)
        prog.render_block()  # compile + warm
        n = prog.engine_config.block_frames
        # drive the production pump loop itself (Player.run): pipelined
        # dispatch, per-block host bookkeeping, output.write
        iters = 0
        t0 = time.perf_counter()
        while True:
            prog.run(duration_frames=8 * n)
            iters += 8
            if iters >= min_iters and time.perf_counter() - t0 > min_secs:
                break
        dt = time.perf_counter() - t0
        return iters * n / prog.engine_config.sample_rate / dt
    state = prog.init_state()
    inputs = prog.packed_block_inputs(0)
    state, audio = prog.step_packed(state, inputs)
    jax.block_until_ready(audio)
    iters = 0
    t0 = time.perf_counter()
    while True:
        state, audio = prog.step_packed(state, inputs)
        iters += 1
        if iters >= min_iters and time.perf_counter() - t0 > min_secs:
            break
    jax.block_until_ready(audio)
    dt = time.perf_counter() - t0
    return iters * prog.ctx.block_frames / prog.ctx.sample_rate / dt


def main():
    import os

    from phonic_tpu.compile_cache import use_compile_cache
    use_compile_cache(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   ".jax_cache"))
    import jax

    devs = jax.devices()
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    if device["platform"] != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX's default device is {device}")

    results, failed = {}, []
    for name, make in CONFIGS.items():
        try:
            rt = bench_program(make())
        except Exception as e:
            failed.append(name)
            results[name] = f"error: {type(e).__name__}: {e}"
            print(f"  {name}: ERROR {e}", file=sys.stderr)
            continue
        results[name] = rt
        print(f"  {name}: {rt:.1f}x realtime", file=sys.stderr)

    value = results.get(HEADLINE)
    print(json.dumps({
        "metric": "audio_seconds_rendered_per_sec",
        "value": value if isinstance(value, float) else None,
        "unit": "x_realtime_48kHz_stereo_16src_mixergraph",
        "device": device,
        "configs": results,
    }))
    if failed:
        sys.exit(f"configs failed: {', '.join(failed)}")


if __name__ == "__main__":
    main()
