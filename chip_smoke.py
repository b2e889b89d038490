#!/usr/bin/env python3
"""On-card smoke test: the render engine's main path on one NVIDIA GPU.

    python3 chip_smoke.py                 # phases 0-2 on one card
    python3 chip_smoke.py --four-cards    # phase 0 + phase 3 on four cards

Phase 0  the device: a GPU or nothing (no CPU fallback); the card's name and
         power limit from nvidia-smi.
Phase 1  every hand-written kernel compiled for the card at real widths
         (n = 131072, one row and 8 vmapped lanes; n = 8191 for the
         unrolled remainder), compared with its plain XLA version and a
         float64 NumPy oracle, and timed against the XLA version; the read
         paths that replaced the removed kernels; how the card rounds
         division, exp2 and multiply-add against the CPU and a float64
         oracle, and the granular pitch/position arithmetic bit for bit.
Phase 2  the bench.py deployments end to end through RenderProgram / Player:
         compile seconds, steady ms per block, x real time, peak device
         bytes, and the GPU output against the same program rendered on the
         process's CPU device.
Phase 3  (--four-cards only) lanes sharded over four cards and one graph
         sharded over four cards, each against the unsharded program; the
         sharded lane programs hold no all-gather.

Any failed check raises, so the script exits non-zero and never prints the
final ``{"ok": true, ...}`` line.  One JAX process drives the card(s).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
N = 131072  # one offline block
LANES = 8
ODD_N = 8191  # a block length that leaves the kernels' unrolled remainder
TOL_DB = -90.0
TOL_SHARDED_DB = -120.0


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg=""):
    print(msg, flush=True)


def error_db(got, want):
    """Peak error in dB relative to the reference's peak (the repo's
    tests/reference_dsp.error_db)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from reference_dsp import error_db as _error_db
    return _error_db(got, want)


def on_cpu(fn, *args):
    """``fn(*args)`` jitted for the process's CPU device, as NumPy."""
    import jax
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        return np.asarray(jax.jit(fn)(*jax.device_put(args, cpu)))


def time_ms(fn, *args, reps=20):
    """Median wall ms of ``fn(*args)`` after one warm-up call, each call
    ended with block_until_ready.  Returns (ms, last output)."""
    import jax
    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts)), out


# ---------------------------------------------------------------------------
# phase 0: the device
# ---------------------------------------------------------------------------


def phase0(want_count):
    import jax
    devs = jax.devices()
    check(devs and devs[0].platform == "gpu",
          f"no GPU: jax.devices()[0] is {devs[0].platform!r}")
    check(len(devs) >= want_count,
          f"need {want_count} GPUs, JAX sees {len(devs)}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(card, "nvidia-smi reported no card")
    log(f"[phase 0] jax {jax.__version__}: {len(devs)} x "
        f"{devs[0].device_kind} ({devs[0].platform})")
    for line in card:
        log(f"[phase 0] nvidia-smi: {line}")
    return card[0]


# ---------------------------------------------------------------------------
# phase 1: kernels at real widths
# ---------------------------------------------------------------------------


def _dynamics_streams(rows, seed):
    """dB-domain detector streams that cross the gate threshold (-40 dB)
    about 90 times per block: 1500-sample loud/quiet segments plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(N)
    loud = ((t // 1500) % 2).astype(bool)
    x = np.where(loud, -10.0, -70.0)[None, :] + rng.normal(0, 3, (rows, N))
    aa = np.full((rows, N), 0.05)
    ra = np.full((rows, N), 0.002)
    thr = np.full((rows, N), -40.0)
    rng_db = np.full((rows, N), -60.0)
    hs = np.full((rows, N), 441.0)
    return [a.astype(np.float32) for a in (x, aa, ra, thr, rng_db, hs)]


def _oracle_follower(x, aa, ra, env):
    """float64 per-sample follower (reference_dsp.envelope_follower in the
    engine's alpha form)."""
    out = np.empty(len(x))
    for i, (v, a_att, a_rel) in enumerate(zip(x.tolist(), aa.tolist(),
                                              ra.tolist())):
        a = a_att if v > env else a_rel
        env = env + a * (v - env)
        out[i] = env
    return out


def _oracle_gate(x, aa, ra, thr, rng, hs, env, hold, gain):
    """float64 per-sample gate machine (the logic of
    reference_dsp.gate_gains, returning gain in dB)."""
    out = np.empty(len(x))
    for i, (v, a_att, a_rel, t, r, h) in enumerate(zip(
            x.tolist(), aa.tolist(), ra.tolist(), thr.tolist(), rng.tolist(),
            hs.tolist())):
        a = a_att if v > env else a_rel
        env = env + a * (v - env)
        is_open = env >= t
        target = 0.0 if (is_open or hold > 0) else r
        hold = h if is_open else max(hold - 1.0, 0.0)
        a2 = a_att if target > gain else a_rel
        gain = gain + a2 * (target - gain)
        out[i] = gain
    return out


def _compare(name, got, on_card, oracle):
    e_card = error_db(got, on_card)
    e_oracle = error_db(got, oracle)
    log(f"[phase 1] {name}: vs XLA on card {e_card:.1f} dB, "
        f"vs float64 oracle {e_oracle:.1f} dB (limit {TOL_DB:.0f} dB)")
    check(e_card <= TOL_DB and e_oracle <= TOL_DB,
          f"{name} error above {TOL_DB} dB")


def phase1_dynamics():
    import jax
    import jax.numpy as jnp
    from phonic_tpu.ops import follower as fo

    x, aa, ra, thr, rng, hs = (jnp.asarray(a) for a in
                               _dynamics_streams(LANES, seed=0))
    env0 = jnp.float32(-120.0)
    st0 = (jnp.float32(-120.0), jnp.float32(0.0), jnp.float32(-60.0))

    fol_kernel = jax.jit(lambda x, aa, ra: fo.asym_follower(x, aa, ra, env0))
    fol_xla = jax.jit(lambda x, aa, ra: fo._follower_xla(x, aa, ra, env0))
    gate_kernel = jax.jit(
        lambda *s: fo.gate_machine(*s, *st0))
    gate_xla = jax.jit(lambda x, aa, ra, thr, rng, hs: fo._gate_xla(
        x, aa, ra, thr, rng, hs, *st0))
    hlo = fol_kernel.lower(x[0], aa[0], ra[0]).as_text()
    check("triton" in hlo,
          "asym_follower did not lower to the Triton kernel on the GPU")

    for lanes in (1, LANES):
        sl = slice(0, lanes)
        fol = [a[sl] for a in (x, aa, ra)]
        gat = [a[sl] for a in (x, aa, ra, thr, rng, hs)]
        if lanes == 1:
            fk, fx, gk, gx = fol_kernel, fol_xla, gate_kernel, gate_xla
            fol = [a[0] for a in fol]
            gat = [a[0] for a in gat]
        else:
            fk, fx, gk, gx = (jax.jit(jax.vmap(f)) for f in
                              (fol_kernel, fol_xla, gate_kernel, gate_xla))
        t_fk, (_, env_k) = time_ms(fk, *fol)
        t_fx, (_, env_x) = time_ms(fx, *fol)
        t_gk, (_, g_k) = time_ms(gk, *gat)
        t_gx, (_, g_x) = time_ms(gx, *gat)
        log(f"[phase 1] follower n={N} lanes={lanes}: Triton kernel "
            f"{t_fk:.3f} ms, XLA scan {t_fx:.3f} ms")
        log(f"[phase 1] gate     n={N} lanes={lanes}: Triton kernel "
            f"{t_gk:.3f} ms, XLA scan {t_gx:.3f} ms")
        env_k, env_x = (np.asarray(a).reshape(lanes, N) for a in (env_k, env_x))
        g_k, g_x = (np.asarray(a).reshape(lanes, N) for a in (g_k, g_x))
        host = [np.asarray(a, np.float64)[:lanes] for a in
                (x, aa, ra, thr, rng, hs)]
        env_o = np.stack([_oracle_follower(*(h[i] for h in host[:3]), -120.0)
                          for i in range(lanes)])
        g_o = np.stack([_oracle_gate(*(h[i] for h in host), -120.0, 0.0,
                                     -60.0) for i in range(lanes)])
        _compare(f"follower lanes={lanes}", env_k, env_x, env_o)
        _compare(f"gate lanes={lanes}", g_k, g_x, g_o)

    host = [np.asarray(a[0, :ODD_N], np.float64) for a in
            (x, aa, ra, thr, rng, hs)]
    fol = [a[0, :ODD_N] for a in (x, aa, ra)]
    gat = [a[0, :ODD_N] for a in (x, aa, ra, thr, rng, hs)]
    _compare(f"follower n={ODD_N}", fol_kernel(*fol)[1], fol_xla(*fol)[1],
             _oracle_follower(*host[:3], -120.0))
    _compare(f"gate n={ODD_N}", gate_kernel(*gat)[1], gate_xla(*gat)[1],
             _oracle_gate(*host, -120.0, 0.0, -60.0))


def phase1_reads():
    """The read paths that replaced removed kernels: the granular gather at
    granular_1k widths (10 voices x 100 grains x 2048-frame
    chunks), and the file-source gather vs the one-hot mm2 read at
    play_file widths (262144 frames)."""
    import jax
    import jax.numpy as jnp
    from phonic_tpu.generators import granular as gr
    from phonic_tpu.ops import resample as rs

    rng = np.random.default_rng(1)
    voices, pool, chunk, frames = 10, 100, 2048, 96000
    mono = jnp.asarray(rng.uniform(-1, 1, frames).astype(np.float32))
    pos0 = rng.uniform(0, 1, (voices, pool, 1))
    inc = rng.uniform(0.5, 1.0, (voices, pool, 1)) / frames
    j = np.arange(chunk)[None, None, :]
    fidx = jnp.asarray((np.mod(pos0 + j * inc, 1.0) * (frames - 1))
                       .astype(np.float32))
    wmode = jnp.asarray(rng.integers(0, 8, (voices, pool)).astype(np.int32))
    wphase = jnp.asarray(np.clip(rng.uniform(-0.2, 0.6, (voices, pool, 1))
                                 + j / 20000.0, 0, 1).astype(np.float32))
    table = jnp.asarray(gr.grain_windows().reshape(-1))

    def gather(mono, table, fidx, wmode, wphase):
        env = gr.window_sample(
            jnp.broadcast_to(wmode[..., None], wphase.shape), wphase, table)
        return gr.catmull_rom_gather(mono, fidx) * env

    args = (mono, table, fidx, wmode, wphase)
    t_g, out_g = time_ms(jax.jit(gather), *args)
    e = error_db(out_g, on_cpu(gather, *args))
    reads = voices * pool * chunk
    log(f"[phase 1] granular gather read + window, {voices}x{pool}x{chunk}: "
        f"{t_g:.3f} ms; moves {reads * 4 * 4 / 1e6:.1f} MB of positions, "
        f"phases, modes and outputs plus {reads * 6 * 4 / 1e6:.1f} MB of "
        f"gathered taps and window entries; vs CPU {e:.1f} dB")
    check(e <= TOL_DB, "granular gather read differs from the CPU")

    n = 2 * N
    buf = rng.uniform(-1, 1, (1, 48001)).astype(np.float32)
    buf[:, -1] = 0.0
    pos = jnp.asarray(np.mod(np.arange(n) * 1.09, 48000.0)
                      .astype(np.float32))
    t_gather, out_gather = time_ms(jax.jit(rs.hermite_read), jnp.asarray(buf),
                                   pos)
    mm2 = jax.jit(lambda b, p: rs.hermite_read_mm2(b, p, smax=2.0))
    t_mm2, out_mm2 = time_ms(mm2, jnp.asarray(rs.mm_pack(buf)), pos)
    e = error_db(out_mm2, out_gather)
    log(f"[phase 1] play_file read, {n} frames from 48001: hermite_read "
        f"gather {t_gather:.3f} ms, hermite_read_mm2 {t_mm2:.3f} ms; "
        f"mm2 vs gather {e:.1f} dB")
    check(e <= TOL_DB, "hermite_read_mm2 differs from hermite_read")


def phase1_rounding():
    """How the card rounds the operations a grain's pitch and read position
    are built from, beside the CPU, each against a float64 oracle; then the
    granular pitch and read-offset arithmetic, which must give the same
    bits on both (a one-ulp increment moves a grain ~0.01 frames)."""
    import jax
    import jax.numpy as jnp
    from phonic_tpu.generators import granular as gr

    rng = np.random.default_rng(2)
    f32, f64 = np.float32, np.float64
    d = np.arange(2, 150001, dtype=np.int32)
    sem = rng.uniform(-1, 1, 10**6).astype(f32)
    a, b, c = (rng.uniform(-1, 1, 10**6).astype(f32) for _ in range(3))
    for name, fn, args, oracle in (
            ("1/d for d = 2..150000", lambda d: 1.0 / d.astype(jnp.float32),
             (d,), (1.0 / d.astype(f64)).astype(f32)),
            ("exp2(s/12) for |s| < 1", lambda s: jnp.exp2(s / 12.0), (sem,),
             np.exp2(sem.astype(f64) / 12.0).astype(f32)),
            ("a*b + c against one rounding (fused)", lambda a, b, c: a * b + c,
             (a, b, c), (a.astype(f64) * b + c).astype(f32))):
        card, cpu = np.asarray(jax.jit(fn)(*args)), on_cpu(fn, *args)
        log(f"[phase 1] rounding of {name}: the card differs from the "
            f"float64 oracle in {np.mean(card != oracle):.2%}, the CPU in "
            f"{np.mean(cpu != oracle):.2%}")
    local = rng.integers(0, 144000, 10**6).astype(f32)
    inc = (rng.uniform(-3, 3, 10**6) / 96000).astype(f32)
    for name, fn, args in (("granular pitch ratio", gr._pitch_ratio, (sem,)),
                           ("granular read offset", gr._split_product,
                            (local, inc))):
        n = int(np.sum(np.asarray(jax.jit(fn)(*args)) != on_cpu(fn, *args)))
        log(f"[phase 1] {name}: {n} of {args[0].size} differ between the "
            f"card and the CPU")
        check(n == 0, f"{name} rounds differently on the card")


# ---------------------------------------------------------------------------
# phase 2: the deployments end to end
# ---------------------------------------------------------------------------

E2E_BLOCKS = 8  # timed blocks after the compiling first one
CPU_FRAMES = 2 * N  # compared against the CPU render


def _render(make, blocks):
    """Build a bench config and render ``blocks`` blocks through its
    production path on the default device.  Returns (compile + first
    block seconds, steady ms per block over the rest, audio [ch, frames],
    jit cache size, block frames, MiB of device memory in use while the
    program, its state and every block's output are alive)."""
    import jax
    prog = make()
    if hasattr(prog, "render_block"):  # a live Player
        def step():
            return prog.render_block()
        n = prog.engine_config.block_frames
    else:
        state = [prog.init_state()]
        n = prog.ctx.block_frames
        index = iter(range(blocks))

        def step():
            state[0], y = prog.step_packed(
                state[0], prog.packed_block_inputs(next(index)))
            return y
    t0 = time.perf_counter()
    outs = [jax.block_until_ready(step())]
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs += [step() for _ in range(blocks - 1)]
    jax.block_until_ready(outs)
    ms = 1e3 * (time.perf_counter() - t0) / max(blocks - 1, 1)
    live = (jax.devices()[0].memory_stats() or {}).get("bytes_in_use", 0)
    engine = prog._program if hasattr(prog, "_program") else prog
    audio = np.concatenate([np.asarray(o) for o in outs], axis=-1)
    return compile_s, ms, audio, engine.jit_cache_size(), n, live / 2**20


def _render_cpu(make, frames):
    import jax
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        prog = make()
        n = (prog.engine_config.block_frames if hasattr(prog, "render_block")
             else prog.ctx.block_frames)
        return _render(lambda: prog, -(-frames // n))[2][:, :frames]


def _statistical(got, want, window=2048):
    """tests/test_chorus_reverb.py::test_reverb_with_vibrato_statistical:
    2048-frame windowed RMS within 1 dB wherever the reference is audible.
    Returns the worst window's |dB|."""
    worst = 0.0
    for t0 in range(0, want.shape[-1] - window, window):
        g = np.sqrt(np.mean(got[:, t0:t0 + window] ** 2))
        e = np.sqrt(np.mean(want[:, t0:t0 + window] ** 2))
        if e > 1e-5:
            worst = max(worst, abs(20 * np.log10(g / e)))
    return worst


def _e2e(name, make, card, label=None):
    import jax
    label = label or name
    peak = lambda: (jax.devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use", 0) / 2**20
    peak_before = peak()
    compile_s, ms, audio, cache, n, live = _render(make, E2E_BLOCKS + 1)
    xrt = n / 48000.0 / (ms / 1e3)
    log(f"[phase 2] {label}: {E2E_BLOCKS + 1} blocks of {n}, compile + first "
        f"block {compile_s:.1f} s, steady {ms:.3f} ms/block = {xrt:.1f}x real "
        f"time, jit cache {cache} [{card}]")
    log(f"[phase 2] {label}: device memory {live:.1f} MiB in use with the "
        f"program, its state and all {E2E_BLOCKS + 1} blocks alive; process "
        f"peak {peak():.1f} MiB, raised {peak() - peak_before:.1f} MiB by "
        f"this config")
    check(cache == 1, f"{label}: {cache} compiled variants after warm-up")
    check(np.isfinite(audio).all(), f"{label}: non-finite output")
    check(np.abs(audio).max() > 1e-4, f"{label}: silent output")
    return audio, ms


def _vs_cpu(label, make, audio, statistical=False):
    want = _render_cpu(make, min(CPU_FRAMES, audio.shape[-1]))
    got = audio[:, :want.shape[-1]]
    e = error_db(got, want)
    if statistical:
        worst = _statistical(got, want)
        log(f"[phase 2] {label} vs CPU: peak error {e:.1f} dB (chaotic "
            f"vibrato'd reverb); windowed RMS within {worst:.3f} dB "
            f"(limit 1 dB)")
        check(worst < 1.0, f"{label}: windowed RMS differs from the CPU")
    else:
        log(f"[phase 2] {label} vs CPU: {e:.1f} dB (limit {TOL_DB:.0f} dB)")
        check(e <= TOL_DB, f"{label}: GPU output differs from the CPU")


def phase2(card):
    """Every config runs even when an earlier one fails; the phase fails
    at its end if any did."""
    import contextlib
    import bench
    from phonic_tpu.ops import follower as fo

    failures = []

    @contextlib.contextmanager
    def config():
        try:
            yield
        except SmokeFailure as e:
            log(f"[phase 2] FAILED: {e}")
            failures.append(str(e))

    for name in ("play_file", "sampler_64v", "granular_1k"):
        with config():
            audio, _ = _e2e(name, bench.CONFIGS[name], card)
            _vs_cpu(name, bench.CONFIGS[name], audio)

    @contextlib.contextmanager
    def xla_followers():
        saved = fo.asym_follower, fo.gate_machine
        fo.asym_follower, fo.gate_machine = fo._follower_xla, fo._gate_xla
        try:
            yield
        finally:
            fo.asym_follower, fo.gate_machine = saved

    make = bench.config_mastering
    with config():
        audio, ms_kernel = _e2e("mastering_chain", make, card)
        _vs_cpu("mastering_chain", make, audio)
        with xla_followers():
            audio_x, ms_xla = _e2e("mastering_chain", make, card,
                                   "mastering_chain with XLA-scan followers")
        e = error_db(audio, audio_x)
        log(f"[phase 2] mastering_chain end to end: Triton followers "
            f"{ms_kernel:.3f} ms/block, XLA-scan followers {ms_xla:.3f} "
            f"ms/block; outputs {e:.1f} dB apart [{card}]")
        check(e <= TOL_DB, "mastering_chain: kernel and XLA followers disagree")
        check(ms_kernel < ms_xla,
              "mastering_chain: the follower kernel is not faster end to end")

    for name, make in (("mixer_graph_16src", bench.config_mixer_graph),
                       ("player_rt_8192", bench.config_player_rt)):
        with config():
            audio, _ = _e2e(name, make, card)
            _vs_cpu(name, make, audio, statistical=True)
        dry = lambda make=make: make(reverb=False)
        label = f"{name} without the reverb"
        with config():
            audio, _ = _e2e(name, dry, card, label)
            _vs_cpu(label, dry, audio)
    check(not failures, f"{len(failures)} phase-2 checks failed")


# ---------------------------------------------------------------------------
# phase 3: four cards
# ---------------------------------------------------------------------------


def _run_blocks(step, init, inputs, blocks=2):
    """Render ``blocks`` blocks; returns (audio, first block's arguments)."""
    st, outs = init(), []
    for b in range(blocks):
        args = (st, inputs(b))
        first = args if b == 0 else first
        st, y = step(*args)
        outs.append(y)
    return np.concatenate([np.asarray(o) for o in outs], axis=-1), first


def sharded_lanes(make, devices):
    """``LANES`` lanes of ``make()`` with mixdown on ``data_mesh(devices)``
    and on one device.  Returns (sharded audio, single audio, the sharded
    step's compiled HLO)."""
    from phonic_tpu.parallel.mesh import BatchedRenderProgram, data_mesh
    sharded = BatchedRenderProgram(make(), lanes=LANES,
                                   mesh=data_mesh(devices), mixdown=True)
    single = BatchedRenderProgram(make(), lanes=LANES, mixdown=True)
    a, first = _run_blocks(sharded.step, sharded.init_states,
                           sharded.block_inputs)
    b, _ = _run_blocks(single.step, single.init_states, single.block_inputs)
    return a[0], b[0], sharded.step.lower(*first).compile().as_text()


def sharded_graph(make, devices):
    """``make()`` as a GraphShardedProgram over ``devices`` devices and
    unsharded.  Returns (sharded audio, unsharded audio)."""
    import jax
    from jax.sharding import Mesh
    from phonic_tpu.parallel.mesh import GraphShardedProgram
    sharded = GraphShardedProgram(
        make(), Mesh(np.array(jax.devices()[:devices]), ("graph",)))
    ref = make()
    return (_run_blocks(sharded.step, sharded.init_state,
                        sharded.block_inputs)[0],
            _run_blocks(ref.step_packed, ref.init_state,
                        ref.packed_block_inputs)[0])


def phase3():
    """Lanes and one graph sharded over four cards, each against the
    unsharded program: mixer_graph_16src both ways, and mastering_chain's
    lanes, whose follower kernel is a custom call that the compiler cannot
    partition.  Each pair must agree to TOL_SHARDED_DB, and a sharded lane
    program must hold no all-gather (lanes never exchange data; the mixdown
    is one all-reduce).  Every pair runs before the phase fails."""
    import bench

    failures = []
    for label, make, pair in (
            ("mastering_chain, 8 lanes on data_mesh(4) with mixdown vs one "
             "card", bench.config_mastering, sharded_lanes),
            ("mixer_graph_16src, 8 lanes on data_mesh(4) with mixdown vs "
             "one card", bench.config_mixer_graph, sharded_lanes),
            ("mixer_graph_16src, GraphShardedProgram on 4 cards vs "
             "unsharded", bench.config_mixer_graph, sharded_graph)):
        t0 = time.perf_counter()
        a, b, *hlo = pair(make, 4)
        e = error_db(a, b)
        ok = bool(np.isfinite(a).all()) and e <= TOL_SHARDED_DB
        msg = (f"{e:.1f} dB (limit {TOL_SHARDED_DB:.0f} dB), "
               f"{time.perf_counter() - t0:.0f} s with compiles")
        if hlo:
            gathers = len(re.findall(r"\ball-gather(?:-start)?\(", hlo[0]))
            kernels = sum("triton" in line.lower() and " = " in line
                          for line in hlo[0].splitlines())
            msg += (f"; compiled sharded step: {gathers} all-gathers, "
                    f"{kernels} instructions naming Triton")
            ok = ok and gathers == 0
            if make is bench.config_mastering:
                ok = ok and kernels > 0
        log(f"[phase 3] {label}: {msg}")
        if not ok:
            failures.append(label)
    check(not failures, f"sharded paths failed: {failures}")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase (needs 4 GPUs)")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    from phonic_tpu.compile_cache import use_compile_cache
    use_compile_cache(os.path.join(REPO, ".jax_cache"))
    import jax

    card = phase0(4 if args.four_cards else 1)
    if args.four_cards:
        phase3()
    else:
        phase1_dynamics()
        phase1_reads()
        phase1_rounding()
        phase2(card)
    devs = jax.devices()
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
