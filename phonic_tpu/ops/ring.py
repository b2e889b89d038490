"""Ring-buffer delay lines + block-feedback decomposition.

Behavioural spec: reference src/utils/dsp/delay.rs (InterpolatedDelayLine —
fractional linear-interp reads, power-of-two masked ring).

The problem with feedback delays: the written sample depends on earlier
*outputs*, which is sequential.  But the dependency latency equals the delay
length D — writes inside a span of B <= D-1 samples never feed their own
reads.  So a block of N frames processes as a short ``lax.scan`` over N/B
sub-blocks, each fully vectorised: gather fractional reads -> feedback-path
DSP (filters run as mini parallel scans) -> one contiguous ring write.  The
sub-block size B is chosen per compiled program from the smallest delay the
parameters allow; the engine clamps runtime delays to >= B+1 samples.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class Ring(NamedTuple):
    buf: jnp.ndarray  # [channels, R] (R = power of two)
    wpos: jnp.ndarray  # int32, total frames written mod R


def ring_init(channels: int, min_size: int, dtype=jnp.float32) -> Ring:
    r = 1
    while r < min_size:
        r *= 2
    return Ring(jnp.zeros((channels, r), dtype), jnp.zeros((), jnp.int32))


def ring_read_frac(ring: Ring, offsets):
    """Linear-interpolated read at ``wpos - offsets`` (reference
    delay.rs:108-141: read_pos = write_pos - delay).  offsets: [...]
    float32 >= 0.  Returns [channels, ...]."""
    r = ring.buf.shape[-1]
    mask = r - 1
    # Reduce wpos mod R BEFORE the float cast: wpos itself grows to 2^30 and
    # would lose integer precision past 2^24 in float32 (wrong slots + frac
    # quantized to 0 after ~6 min at 48 kHz).  wpos & mask and the offsets are
    # both bounded by R, so the reduced arithmetic is exact; a negative pos is
    # fine (floor + two's-complement masking wrap it correctly).
    # Position math runs in the ring's own float dtype so f64 strict-parity
    # rings get f64 interpolation fractions.
    ptype = ring.buf.dtype if jnp.issubdtype(ring.buf.dtype, jnp.floating) \
        else jnp.float32
    pos = (ring.wpos & mask).astype(ptype) - jnp.asarray(offsets).astype(ptype)
    ip = jnp.floor(pos)
    frac = (pos - ip).astype(ring.buf.dtype)
    i1 = ip.astype(jnp.int32) & mask
    i2 = (ip.astype(jnp.int32) + 1) & mask
    v1 = jnp.take(ring.buf, i1, axis=-1)
    v2 = jnp.take(ring.buf, i2, axis=-1)
    return v1 + (v2 - v1) * frac


import jax


def ring_write_block(ring: Ring, x) -> Ring:
    """Append [channels, B] frames.  When writes are always B-sized (our
    usage: one write per sub-block) and R % B == 0, the write start is always
    B-aligned, so a single contiguous dynamic_update_slice suffices — no wrap
    handling, no scatter."""
    r = ring.buf.shape[-1]
    b = x.shape[-1]
    start = ring.wpos & (r - 1)
    if r % b == 0:
        buf = jax.lax.dynamic_update_slice(
            ring.buf, x.astype(ring.buf.dtype), (jnp.zeros_like(start), start)
        )
    else:
        idx = (start + jnp.arange(b, dtype=jnp.int32)) & (r - 1)
        buf = ring.buf.at[:, idx].set(x.astype(ring.buf.dtype))
    return Ring(buf, (ring.wpos + b) & jnp.int32(2**30 - 1))


def pick_subblock(min_delay_samples: float, block_frames: int, cap: int = 2048) -> int:
    """Largest power-of-two sub-block B with B + 1 <= min delay, dividing
    block_frames; at least 1."""
    b = 1
    while (
        b * 2 + 1 <= int(min_delay_samples)
        and b * 2 <= cap
        and block_frames % (b * 2) == 0
    ):
        b *= 2
    return b
