"""Per-sample nonlinear dynamics recurrences: asymmetric envelope follower
and the gate state machine.

Behavioural spec: reference src/effect/compressor.rs (dB-domain
attack/release follower, :283-301) and src/effect/gate.rs (envelope ->
open/hold/closed machine -> gain smoothing, :147-195).

These recurrences branch on the carried state (attack vs release is chosen
by comparing the input to the running envelope), so unlike the linear
smoothers in ops/scan.py they cannot ride an associative scan.  XLA runs
them as a sequential ``lax.scan``.  On a CUDA device the float32 path runs
a Pallas kernel through Triton instead: one program per row holds the
state in registers and walks the whole block, loading a chunk of steps of
input at the top of each loop iteration so the loads overlap instead of
sitting on the dependent chain.

Routing: float32 rows lower to the kernel on CUDA and to the XLA scan on
every other platform (``lax.platform_dependent``, decided when the program
is lowered for its device); float64 strict-parity renders always take the
XLA scan.  tests/test_follower.py pins the kernel (interpret mode) to the
scan and to a per-sample NumPy oracle.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

# steps per kernel loop iteration: their loads are issued together, ahead
# of the dependent chain (the gate carries twice the streams, so half the
# steps)
_FOLLOWER_UNROLL = 64
_GATE_UNROLL = 32


def _row_call(kernel, streams, state0, unroll, interpret):
    """Launch ``kernel`` with one program per row of the [R, n] ``streams``;
    ``state0`` is [R, S].  Returns (out [R, n], state [R, S])."""
    r, n = streams[0].shape
    s = state0.shape[-1]
    row = pl.BlockSpec((1, n), lambda i: (i, 0))
    st = pl.BlockSpec((1, s), lambda i: (i, 0))
    out, st_end = pl.pallas_call(
        functools.partial(kernel, n, unroll),
        grid=(r,),
        in_specs=[row] * len(streams) + [st],
        out_specs=(row, st),
        out_shape=(jax.ShapeDtypeStruct((r, n), jnp.float32),
                   jax.ShapeDtypeStruct((r, s), jnp.float32)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name=kernel.__name__,
    )(*streams, state0)
    return out, st_end


# ---------------------------------------------------------------------------
# asymmetric one-pole follower: env' = env + a * (in - env),
# a = aa if in > env else ra            (compressor.rs:283-301)
# ---------------------------------------------------------------------------


def _follower_step(env, in_db, aa, ra):
    a = jnp.where(in_db > env, aa, ra)
    return env + a * (in_db - env)


def follower_kernel(n, unroll, x_ref, aa_ref, ra_ref, st0_ref, out_ref,
                    st_ref):
    def body(c, env):
        base = c * unroll
        xs = [(x_ref[0, base + k], aa_ref[0, base + k], ra_ref[0, base + k])
              for k in range(unroll)]
        for k, (x, aa, ra) in enumerate(xs):
            env = _follower_step(env, x, aa, ra)
            out_ref[0, base + k] = env
        return env

    # whole chunks in the loop, the remainder unrolled after it
    n_full = n // unroll
    env = jax.lax.fori_loop(0, n_full, body, st0_ref[0, 0])
    for k in range(n - n_full * unroll):
        i = n_full * unroll + k
        env = _follower_step(env, x_ref[0, i], aa_ref[0, i], ra_ref[0, i])
        out_ref[0, i] = env
    st_ref[0, 0] = env


def follower_rows(in_db, aa, ra, env0, *, interpret=False):
    """The follower kernel over [R, n] rows; env0 [R].  Returns
    (env_end [R], envelope [R, n])."""
    out, st = _row_call(follower_kernel, [in_db, aa, ra], env0[:, None],
                        _FOLLOWER_UNROLL, interpret)
    return st[:, 0], out


def _follower_xla(in_db, aa, ra, env0):
    def step(env, xs):
        env = _follower_step(env, *xs)
        return env, env

    env_end, envelope = jax.lax.scan(step, env0, (in_db, aa, ra), unroll=64)
    return env_end, envelope


def asym_follower(in_db, attack_a, release_a, env0):
    """dB-domain attack/release follower over one block.

    in_db/attack_a/release_a: [n]; env0: scalar.
    Returns (env_end, envelope[n]).
    """
    if in_db.dtype != jnp.float32:
        return _follower_xla(in_db, attack_a, release_a, env0)

    def kernel(in_db, aa, ra, env0):
        env_end, env = follower_rows(in_db[None], aa[None], ra[None],
                                     jnp.reshape(env0, (1,)))
        return env_end[0], env[0]

    return jax.lax.platform_dependent(
        in_db, attack_a, release_a, jnp.asarray(env0, jnp.float32),
        cuda=kernel, default=_follower_xla)


# ---------------------------------------------------------------------------
# gate machine (gate.rs:147-195): follower + open/hold/closed + gain smooth
# ---------------------------------------------------------------------------


def _gate_step(st, in_db, aa, ra, thr, rng, hs):
    env, hold, gain_db = st
    env = _follower_step(env, in_db, aa, ra)
    is_open = env >= thr
    target = jnp.where(is_open | (hold > 0), 0.0, rng)
    hold = jnp.where(is_open, hs, jnp.maximum(hold - 1.0, 0.0))
    a2 = jnp.where(target > gain_db, aa, ra)
    gain_db = gain_db + a2 * (target - gain_db)
    return env, hold, gain_db


def gate_kernel(n, unroll, x_ref, aa_ref, ra_ref, thr_ref, rng_ref, hs_ref,
                st0_ref, out_ref, st_ref):
    refs = (x_ref, aa_ref, ra_ref, thr_ref, rng_ref, hs_ref)

    def body(c, st):
        base = c * unroll
        xs = [tuple(r[0, base + k] for r in refs) for k in range(unroll)]
        for k, args in enumerate(xs):
            st = _gate_step(st, *args)
            out_ref[0, base + k] = st[2]
        return st

    n_full = n // unroll
    st = jax.lax.fori_loop(
        0, n_full, body, (st0_ref[0, 0], st0_ref[0, 1], st0_ref[0, 2]))
    for k in range(n - n_full * unroll):
        i = n_full * unroll + k
        st = _gate_step(st, *(r[0, i] for r in refs))
        out_ref[0, i] = st[2]
    for j in range(3):
        st_ref[0, j] = st[j]


def gate_rows(in_db, aa, ra, thr, rng, hs, st0, *, interpret=False):
    """The gate kernel over [R, n] rows; st0 [R, 3] = (env, hold, gain_db).
    Returns (state [R, 3], gains_db [R, n])."""
    out, st = _row_call(gate_kernel, [in_db, aa, ra, thr, rng, hs], st0,
                        _GATE_UNROLL, interpret)
    return st, out


def _gate_xla(in_db, aa, ra, thr, rng, hs, env0, hold0, gain0):
    def step(carry, xs):
        in_db, thr, rng, aa, ra, hs = xs
        st = _gate_step(carry, in_db, aa, ra, thr, rng, hs)
        return st, st[2]

    (env, hold, gain_db), gains = jax.lax.scan(
        step, (env0, hold0, gain0), (in_db, thr, rng, aa, ra, hs), unroll=64)
    return (env, hold, gain_db), gains


def gate_machine(in_db, attack_a, release_a, threshold, range_db,
                 hold_samples, env0, hold0, gain0):
    """Full gate recurrence over one block; all streams [n], state
    scalars.  Returns ((env, hold, gain_db), gains_db[n])."""
    args = (in_db, attack_a, release_a, threshold, range_db, hold_samples,
            env0, hold0, gain0)
    if in_db.dtype != jnp.float32:
        return _gate_xla(*args)

    def kernel(in_db, aa, ra, thr, rng, hs, env0, hold0, gain0):
        st0 = jnp.stack([env0, hold0, gain0])[None, :]
        st, gains = gate_rows(in_db[None], aa[None], ra[None], thr[None],
                              rng[None], hs[None], st0)
        return (st[0, 0], st[0, 1], st[0, 2]), gains[0]

    args = args[:6] + tuple(jnp.asarray(v, jnp.float32) for v in args[6:])
    return jax.lax.platform_dependent(*args, cuda=kernel, default=_gate_xla)
