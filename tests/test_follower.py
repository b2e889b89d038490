"""ops/follower.py: the Triton kernels (interpret mode on CPU) vs the XLA
scan and vs a per-sample NumPy oracle (gate.rs:147-195,
compressor.rs:283-301)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from phonic_tpu.ops import follower as fo


def _np_follower(x, aa, ra, env0):
    env = np.float32(env0)
    out = np.empty_like(x)
    for i in range(len(x)):
        a = aa[i] if x[i] > env else ra[i]
        env = np.float32(env + a * (x[i] - env))
        out[i] = env
    return env, out


def _np_gate(x, aa, ra, thr, rng, hs, env0, hold0, gain0):
    env, hold, gain = np.float32(env0), np.float32(hold0), np.float32(gain0)
    out = np.empty_like(x)
    for i in range(len(x)):
        a = aa[i] if x[i] > env else ra[i]
        env = np.float32(env + a * (x[i] - env))
        is_open = env >= thr[i]
        target = np.float32(0.0) if (is_open or hold > 0) else rng[i]
        hold = hs[i] if is_open else np.float32(max(hold - 1.0, 0.0))
        a2 = aa[i] if target > gain else ra[i]
        gain = np.float32(gain + a2 * (target - gain))
        out[i] = gain
    return (env, hold, gain), out


def _streams(n, seed=0):
    r = np.random.default_rng(seed)
    x = r.uniform(-90, 0, n).astype(np.float32)
    aa = np.full(n, 0.05, np.float32)
    ra = np.full(n, 0.002, np.float32)
    return x, aa, ra


def _rows(*streams):
    return [jnp.asarray(v)[None] for v in streams]


@pytest.mark.parametrize("n", [4096, 12288])
def test_follower_pallas_matches_oracle(n):
    x, aa, ra = _streams(n)
    env_np, out_np = _np_follower(x, aa, ra, -120.0)
    # the Triton kernel itself (interpret mode on CPU)
    env_end, env = fo.follower_rows(*_rows(x, aa, ra),
                                    jnp.asarray([-120.0], jnp.float32),
                                    interpret=True)
    np.testing.assert_allclose(np.asarray(env)[0], out_np, atol=2e-4)
    np.testing.assert_allclose(np.asarray(env_end)[0], env_np, atol=2e-4)
    # the XLA path
    env_end2, out2 = fo._follower_xla(jnp.asarray(x), jnp.asarray(aa),
                                      jnp.asarray(ra), jnp.float32(-120.0))
    np.testing.assert_allclose(np.asarray(out2), out_np, atol=2e-4)
    np.testing.assert_array_equal(np.asarray(env)[0], np.asarray(out2))


def test_follower_block_carry_matches_single_run():
    # an odd length and a split off the unroll grid exercise the kernel's
    # unrolled remainder and the state carried between calls
    n = 8191
    x, aa, ra = _streams(n, seed=3)
    e0 = jnp.asarray([-120.0], jnp.float32)
    _, whole = fo.follower_rows(*_rows(x, aa, ra), e0, interpret=True)
    h = 3001
    end1, first = fo.follower_rows(*_rows(x[:h], aa[:h], ra[:h]), e0,
                                   interpret=True)
    _, second = fo.follower_rows(*_rows(x[h:], aa[h:], ra[h:]), end1,
                                 interpret=True)
    np.testing.assert_array_equal(
        np.asarray(whole)[0], np.concatenate([first[0], second[0]]))


@pytest.mark.parametrize("n", [4096, 12288])
def test_gate_pallas_matches_oracle(n):
    x, aa, ra = _streams(n, seed=1)
    thr = np.full(n, -40.0, np.float32)
    rng = np.full(n, -60.0, np.float32)
    hs = np.full(n, 441.0, np.float32)
    (env_np, hold_np, gain_np), out_np = _np_gate(
        x, aa, ra, thr, rng, hs, -120.0, 0.0, -60.0)
    st0 = jnp.asarray([[-120.0, 0.0, -60.0]], jnp.float32)
    st, gains = fo.gate_rows(*_rows(x, aa, ra, thr, rng, hs), st0,
                             interpret=True)
    np.testing.assert_allclose(np.asarray(gains)[0], out_np, atol=2e-4)
    np.testing.assert_allclose(np.asarray(st)[0],
                               [env_np, hold_np, gain_np], atol=2e-4)
    # XLA path agrees too
    (e2, h2, g2), out2 = fo._gate_xla(
        jnp.asarray(x), jnp.asarray(aa), jnp.asarray(ra), jnp.asarray(thr),
        jnp.asarray(rng), jnp.asarray(hs), jnp.float32(-120.0),
        jnp.float32(0.0), jnp.float32(-60.0))
    np.testing.assert_allclose(np.asarray(out2), out_np, atol=2e-4)
    np.testing.assert_array_equal(np.asarray(gains)[0], np.asarray(out2))


def _lowered(fn, platform, *args):
    return jax.jit(fn).trace(*args).lower(
        lowering_platforms=(platform,)).as_text()


def test_dispatcher_routes_by_platform_and_dtype():
    # float32 lowers to the Triton kernel for CUDA and to the XLA scan for
    # the CPU; float64 strict-parity streams take the scan everywhere
    n = 8192
    x, aa, ra = _streams(n, seed=2)
    jx, jaa, jra = map(jnp.asarray, (x, aa, ra))

    def follow(x, aa, ra):
        return fo.asym_follower(x, aa, ra, jnp.asarray(-120.0, x.dtype))[1]

    assert "triton" in _lowered(follow, "cuda", jx, jaa, jra)
    assert "triton" not in _lowered(follow, "cpu", jx, jaa, jra)
    x64 = [v.astype(jnp.float64) for v in (jx, jaa, jra)]
    assert "triton" not in _lowered(follow, "cuda", *x64)
    # on the CPU the public entry point is the XLA scan, bit for bit
    env_end, env = fo.asym_follower(jx, jaa, jra, jnp.float32(-120.0))
    env_end2, env2 = fo._follower_xla(jx, jaa, jra, jnp.float32(-120.0))
    np.testing.assert_array_equal(np.asarray(env), np.asarray(env2))


def test_kernels_under_vmap_keep_lane_shapes():
    # BatchedRenderProgram vmaps the whole graph: the kernel's rows become
    # a grid axis, and each lane must match its own scan
    n, lanes = 1000, 3
    xs = [_streams(n, seed=10 + i) for i in range(lanes)]
    x, aa, ra = (jnp.asarray(np.stack([s[k] for s in xs])) for k in range(3))
    e0 = jnp.full((lanes, 1), -120.0, jnp.float32)
    ends, env = jax.vmap(lambda x, aa, ra, e: fo.follower_rows(
        x[None], aa[None], ra[None], e, interpret=True))(x, aa, ra, e0)
    assert env.shape == (lanes, 1, n) and ends.shape == (lanes, 1)
    for i in range(lanes):
        _, ref = fo._follower_xla(x[i], aa[i], ra[i], jnp.float32(-120.0))
        np.testing.assert_array_equal(np.asarray(env[i, 0]), np.asarray(ref))
    thr = jnp.full((lanes, n), -40.0)
    rng = jnp.full((lanes, n), -60.0)
    hs = jnp.full((lanes, n), 441.0)
    st0 = jnp.tile(jnp.asarray([[-120.0, 0.0, -60.0]], jnp.float32),
                   (lanes, 1))[:, None, :]
    st, gains = jax.vmap(lambda *a: fo.gate_rows(
        *(v[None] for v in a[:6]), a[6], interpret=True))(
            x, aa, ra, thr, rng, hs, st0)
    assert gains.shape == (lanes, 1, n) and st.shape == (lanes, 1, 3)
    for i in range(lanes):
        _, ref = fo._gate_xla(x[i], aa[i], ra[i], thr[i], rng[i], hs[i],
                              jnp.float32(-120.0), jnp.float32(0.0),
                              jnp.float32(-60.0))
        np.testing.assert_array_equal(np.asarray(gains[i, 0]),
                                      np.asarray(ref))
