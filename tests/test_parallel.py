"""Multi-chip lane sharding on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import pytest

from phonic_tpu import (AudioFileBuffer, EngineConfig, FilePlaybackOptions,
                        FileSource, Mixer, RenderProgram)
from phonic_tpu.parallel.mesh import BatchedRenderProgram, data_mesh

SR = 48000


def make_prog():
    t = np.arange(SR // 2) / SR
    buf = AudioFileBuffer.from_array(
        (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)[None, :], SR)
    m = Mixer("main")
    m.add_source(FileSource(buf, FilePlaybackOptions(repeat=None, fade_out_secs=0.0)))
    return RenderProgram(m, EngineConfig(sample_rate=SR, block_frames=1024))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_lanes_match_single():
    prog = make_prog()
    mesh = data_mesh(8)
    batched = BatchedRenderProgram(prog, lanes=8, mesh=mesh)
    out = batched.render(4096)
    assert out.shape == (8, 2, 4096)
    # every lane identical to the unsharded render
    single = make_prog().render(duration_frames=4096)
    for lane in range(8):
        np.testing.assert_allclose(out[lane], single, atol=1e-6)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_mixdown_collective():
    prog = make_prog()
    batched = BatchedRenderProgram(prog, lanes=8, mesh=data_mesh(8), mixdown=True)
    states = batched.init_states()
    _, audio = batched.step(states, batched.block_inputs(0))
    assert audio.shape == (1, 2, 1024)
    single = make_prog().render(duration_frames=1024)
    np.testing.assert_allclose(np.asarray(audio[0]), 8.0 * single, atol=1e-4)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("mixdown", [False, True])
def test_sharded_lanes_stay_on_their_device(mixdown):
    # each device renders its own lanes: no all-gather, and the only
    # collective is the mixdown's all-reduce
    batched = BatchedRenderProgram(make_prog(), lanes=8, mesh=data_mesh(8),
                                   mixdown=mixdown)
    hlo = batched.step.lower(batched.init_states(),
                             batched.block_inputs(0)).compile().as_text()
    assert "all-gather" not in hlo
    assert ("all-reduce" in hlo) == mixdown


def make_wide_prog(n_sources=8, n_subs=4, block=1024):
    """Flagship-shaped graph: batched file lanes + batched sibling effect
    chains — the internal axes GraphShardedProgram partitions."""
    from phonic_tpu.effects.gain import GainEffect

    rng = np.random.default_rng(3)
    main = Mixer("main")
    subs = [main.add_mixer(Mixer(f"s{i}")) for i in range(n_subs)]
    for i in range(n_sources):
        t = np.arange(6000 + 500 * i) / SR
        buf = AudioFileBuffer.from_array(
            (0.3 * np.sin(2 * np.pi * float(rng.uniform(100, 500)) * t))
            .astype(np.float32)[None, :], SR)
        subs[i % n_subs].add_source(FileSource(buf, FilePlaybackOptions(
            repeat=None, fade_out_secs=0.0,
            volume=float(rng.uniform(0.3, 0.8)))))
    for s in subs:
        s.add_effect(GainEffect(gain=0.9))
    return RenderProgram(main, EngineConfig(sample_rate=SR, block_frames=block))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_graph_sharded_program_matches_unsharded():
    """Model-parallel single graph: internal batch axes sharded over the
    mesh must be BIT-identical to the unsharded program."""
    from jax.sharding import Mesh
    from phonic_tpu.parallel.mesh import GraphShardedProgram

    prog = make_wide_prog()
    mesh = Mesh(np.array(jax.devices()[:4]), ("graph",))
    sharded = GraphShardedProgram(prog, mesh)
    st = sharded.init_state()
    outs = []
    for b in range(4):
        st, y = sharded.step(st, sharded.block_inputs(b))
        outs.append(np.asarray(y))
    got = np.concatenate(outs, axis=-1)

    ref = make_wide_prog().render(duration_frames=4096)
    np.testing.assert_array_equal(got, ref)


def make_full_family_prog(n_sources=8, n_samplers=4, block=1024):
    """Graph exercising ALL THREE batch-state families the mesh layer
    shards: file_batches, effect_batches and gen_batches (vmapped Sampler
    voice pools), plus feedback-effect ring state (delay) — VERDICT r3 #5."""
    from phonic_tpu import Sampler
    from phonic_tpu.effects.delay import DelayEffect
    from phonic_tpu.effects.gain import GainEffect
    from phonic_tpu.generators.base import GeneratorPlaybackOptions

    rng = np.random.default_rng(3)
    main = Mixer("main")
    subs = [main.add_mixer(Mixer(f"s{i}")) for i in range(4)]
    for i in range(n_sources):
        t = np.arange(6000 + 500 * i) / SR
        buf = AudioFileBuffer.from_array(
            (0.3 * np.sin(2 * np.pi * float(rng.uniform(100, 500)) * t))
            .astype(np.float32)[None, :], SR)
        subs[i % 4].add_source(FileSource(buf, FilePlaybackOptions(
            repeat=None, fade_out_secs=0.0,
            volume=float(rng.uniform(0.3, 0.8)))))
    t = np.arange(5000) / SR
    sbuf = AudioFileBuffer.from_array(
        (0.4 * np.sin(2 * np.pi * 330.0 * t)).astype(np.float32)[None, :], SR)
    for k in range(n_samplers):
        smp = Sampler(sbuf, GeneratorPlaybackOptions(voices=4))
        nid = smp.note_on(60 + k, volume=0.5, time=0)
        smp.note_off(nid, time=8 * block)
        subs[k % 4].add_source(smp)
    for s in subs:
        s.add_effect(GainEffect(gain=0.9))
    main.add_effect(DelayEffect(delay_ms=30.0, feedback=0.3, wet=0.2))
    return RenderProgram(main, EngineConfig(sample_rate=SR, block_frames=block))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_graph_sharded_gen_pools_and_feedback_match_unsharded():
    """Sampler voice pools (gen_batches) + delay-line state sharded over the
    graph axis must stay BIT-identical to the unsharded program."""
    from jax.sharding import Mesh
    from phonic_tpu.parallel.mesh import GraphShardedProgram

    prog = make_full_family_prog()
    assert prog.gen_batches, "samplers should have batched into a pool"
    mesh = Mesh(np.array(jax.devices()[:4]), ("graph",))
    sharded = GraphShardedProgram(prog, mesh)
    st = sharded.init_state()
    outs = []
    for b in range(4):
        st, y = sharded.step(st, sharded.block_inputs(b))
        outs.append(np.asarray(y))
    got = np.concatenate(outs, axis=-1)

    ref = make_full_family_prog().render(duration_frames=4096)
    # 1-ulp tolerance: sharding the voice-pool lane axis lets GSPMD reorder
    # the cross-lane stem reduction (file batches preserve order; the
    # pool's vmapped mean does not)
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_2d_lanes_by_graph_sharding_matches():
    """Lanes on "data" x internal axes on "graph" (the 2D layout the
    driver's dryrun exercises) must match the plain vmapped step."""
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from phonic_tpu.parallel.mesh import graph_state_shardings

    prog = make_wide_prog()
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "graph"))
    st_sh = graph_state_shardings(prog, mesh, "graph", lane_axis="data")
    lanes = 2
    states = jax.tree.map(lambda *xs: jnp.stack(xs),
                          *[prog.init_state() for _ in range(lanes)])
    inp = prog.block_inputs(0)
    tiled = jax.tree.map(
        lambda x: np.broadcast_to(np.asarray(x), (lanes,) + np.shape(x)).copy(),
        inp)
    vstep = jax.jit(jax.vmap(prog._step), in_shardings=(st_sh, None))
    _, audio = vstep(states, tiled)
    _, ref = jax.jit(jax.vmap(prog._step))(states, tiled)
    np.testing.assert_array_equal(np.asarray(audio), np.asarray(ref))


def test_render_scan_matches_block_loop():
    """scan-over-blocks (one dispatch, many blocks) is bit-identical to the
    per-block step loop, unsharded and mesh-sharded."""
    a_loop = BatchedRenderProgram(make_prog(), lanes=4).render(4000)
    a_scan = BatchedRenderProgram(make_prog(), lanes=4).render_scan(4000)
    np.testing.assert_array_equal(a_scan, a_loop)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_render_scan_sharded_matches():
    b = BatchedRenderProgram(make_prog(), lanes=8, mesh=data_mesh(8))
    a_scan = b.render_scan(4096)
    assert a_scan.shape == (8, 2, 4096)
    single = make_prog().render(duration_frames=4096)
    for lane in range(8):
        np.testing.assert_allclose(a_scan[lane], single, atol=1e-6)
