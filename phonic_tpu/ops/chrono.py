"""Chronological feedback delay buffers with gather-free fractional reads.

Behavioural spec: reference src/utils/dsp/delay.rs (InterpolatedDelayLine:
fractional linear-interp reads at ``write_pos - delay``).

This replaces the modulo-ring machinery (ops/ring.py) on the hot path: ring
reads are per-element gathers.  Here the delay line is stored as an
ABSOLUTE-TIME buffer: ``big = history ++ this block's writes``.  Per
sub-block step the write is one contiguous ``dynamic_update_slice`` and the
read resolves inside one contiguous window ``big[:, t0 : t0 + H + B]``
through one-hot row matmuls (one-hot matmuls at ``Precision.HIGHEST``
reproduce the gathered f32 values exactly; the lerp uses the same
``v1 + (v2 - v1) * frac`` expression as ring_read_frac).  Lower dot
precisions (TF32, bf16 passes) truncate the DATA side even with a {0,1}
one-hot operand, so every matmul here asks for HIGHEST.

float64 strict-parity renders use the same chronological layout with a
plain take-based read.

Layout invariants:
  * history length H is a static multiple of 128, H >= max read offset + 2
  * offsets passed to reads must satisfy  B + 1 <= offs <= H - 2  (the
    caller clamps, mirroring the ring's min-delay clamp)
  * ``begin`` -> per-step ``read_frac``/``write`` -> ``end`` per block
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_LANE = 128


class Chrono(NamedTuple):
    hist: jnp.ndarray  # [channels, H], newest sample last


def hist_len(min_offset: int) -> int:
    """Static history length: covers reads up to ``min_offset`` (the max
    read offset in samples) plus the lerp partner, rounded up to lanes."""
    need = int(min_offset) + 2
    return -(-need // _LANE) * _LANE


def chrono_init(channels: int, max_offset: int, dtype=jnp.float32) -> Chrono:
    return Chrono(jnp.zeros((channels, hist_len(max_offset)), dtype))


def begin(state: Chrono, n: int, dtype=None):
    """Extend the history with this block's (not yet written) frames."""
    h = state.hist
    if dtype is not None and h.dtype != dtype:
        h = h.astype(dtype)
    z = jnp.zeros(h.shape[:-1] + (n,), h.dtype)
    return jnp.concatenate([h, z], axis=-1)


def end(big, n: int) -> Chrono:
    return Chrono(big[..., n:])


def write_at(big, H: int, t0, x):
    """Write [ch, B] frames of the block at absolute chrono index H + t0."""
    return jax.lax.dynamic_update_slice(
        big, x.astype(big.dtype), (jnp.zeros_like(t0), H + t0))


def read_frac(big, H: int, t0, offsets):
    """Linear-interpolated read of ``offsets`` (>= B+1, <= H-2) for a
    sub-block starting at local offset ``t0``.

    big: [ch, H + n] chrono buffer; offsets: [B] (shared across channels)
    or [ch, B] (per-channel).  Output sample j reads absolute local time
    t0 + j - offsets[..., j], i.e. window-relative position
    H + j - offsets.  Returns [ch, B].
    """
    ch = big.shape[0]
    per_channel = jnp.asarray(offsets).ndim == 2
    b = jnp.asarray(offsets).shape[-1]
    ptype = big.dtype if jnp.issubdtype(big.dtype, jnp.floating) else jnp.float32
    offs = jnp.asarray(offsets).astype(ptype)
    # exact split: oi = floor(offs), of = offs - oi (Sterbenz-exact), so the
    # integer/fraction split never depends on the magnitude of H + j (the
    # ring path's `wpos - offs` rounds the subtraction at ~2^-11 near 4k
    # offsets; this stays exact to the offset's own ulp)
    oi = jnp.floor(offs)
    of = (offs - oi).astype(big.dtype)
    is_int = of == 0
    j = jnp.arange(b, dtype=jnp.int32)
    rel = H + j - oi.astype(jnp.int32) - jnp.where(is_int, 0, 1)  # [.., B]
    frac = jnp.where(is_int, of, 1.0 - of)

    win = jax.lax.dynamic_slice(
        big, (jnp.int32(0), t0), (ch, H + b))  # [ch, H + B]

    if big.dtype == jnp.float64 or b % _LANE != 0:
        # strict-parity renders / lane-unaligned sub-blocks: plain take
        # (vector-hostile but exact; small B keeps it cheap)
        v1 = jnp.take_along_axis(
            win, jnp.broadcast_to(rel, (ch, b)), axis=-1)
        v2 = jnp.take_along_axis(
            win, jnp.broadcast_to(rel + 1, (ch, b)), axis=-1)
        return v1 + (v2 - v1) * frac

    rows = (H + b) // _LANE
    win2 = win.reshape(ch, rows, _LANE)
    hi = rel >> 7
    lo = rel & 127
    rr = jnp.arange(rows - 1, dtype=jnp.int32)
    lanes = jnp.arange(_LANE, dtype=jnp.int32)

    def mm(oh_hi, oh_lo, w2):
        # [B, rows-1] one-hots select row hi and hi+1; the 1.0 entries make
        # the matmul an exact f32 copy at Precision.HIGHEST (lower
        # precisions are not exact — see module docstring)
        oh = (oh_hi[:, None] == rr[None, :]).astype(w2.dtype)
        w0 = jnp.matmul(oh, w2[:-1], precision=jax.lax.Precision.HIGHEST)
        w1 = jnp.matmul(oh, w2[1:], precision=jax.lax.Precision.HIGHEST)
        o = lanes[None, :] - oh_lo[:, None]  # [B, 128]
        # tap lo is always inside w0; tap lo+1 spills into w1 lane 0 when
        # lo == 127 (o == 1 - 128 selects exactly that lane)
        v1 = jnp.sum(jnp.where(o == 0, w0, 0.0), axis=-1)
        v2 = jnp.sum(jnp.where(o == 1, w0, 0.0), axis=-1) + \
            jnp.sum(jnp.where(o == 1 - _LANE, w1, 0.0), axis=-1)
        return v1, v2

    if per_channel:
        v1, v2 = jax.vmap(mm)(hi, lo, win2)
    else:
        v1, v2 = jax.vmap(mm, in_axes=(None, None, 0))(hi, lo, win2)
    return v1 + (v2 - v1) * frac


def read_frac_win(win, offsets):
    """Rolling-window variant of :func:`read_frac`: ``win`` [ch, W] holds
    the last W samples strictly BEFORE the current sub-block (newest last),
    so no dynamic window slice and — crucially — no [ch, H + n] carry: a
    scan that carries the whole-block buffer copies it every step (XLA
    cannot alias a carry it also dynamically updates), which dominated the
    feedback effects' block cost.  Output sample j reads window-relative
    position W + j - offsets[..., j]; offsets must satisfy
    B + 1 <= offs <= W - 2 (the same clamp as read_frac).  W must be a
    multiple of 128 for the one-hot path."""
    ch, W = win.shape
    per_channel = jnp.asarray(offsets).ndim == 2
    b = jnp.asarray(offsets).shape[-1]
    ptype = win.dtype if jnp.issubdtype(win.dtype, jnp.floating) else jnp.float32
    offs = jnp.asarray(offsets).astype(ptype)
    oi = jnp.floor(offs)
    of = (offs - oi).astype(win.dtype)
    is_int = of == 0
    j = jnp.arange(b, dtype=jnp.int32)
    rel = W + j - oi.astype(jnp.int32) - jnp.where(is_int, 0, 1)
    frac = jnp.where(is_int, of, 1.0 - of)

    if win.dtype == jnp.float64 or W % _LANE != 0:
        v1 = jnp.take_along_axis(
            win, jnp.broadcast_to(rel, (ch, b)), axis=-1)
        v2 = jnp.take_along_axis(
            win, jnp.broadcast_to(rel + 1, (ch, b)), axis=-1)
        return v1 + (v2 - v1) * frac

    rows = W // _LANE
    win2 = win.reshape(ch, rows, _LANE)
    hi = rel >> 7
    lo = rel & 127
    rr = jnp.arange(rows, dtype=jnp.int32)
    lanes = jnp.arange(_LANE, dtype=jnp.int32)

    def mm(oh_hi, oh_lo, w2):
        # hi may reach rows-1 here (rel <= W-2); the +1 spill row is only
        # needed when lo == 127, in which case rel+1 <= W-1 keeps hi at
        # rows-2 — so the spill matmul uses the first rows-1 one-hots
        oh = (oh_hi[:, None] == rr[None, :]).astype(w2.dtype)
        w0 = jnp.matmul(oh, w2, precision=jax.lax.Precision.HIGHEST)
        w1 = jnp.matmul(oh[:, :-1], w2[1:],
                        precision=jax.lax.Precision.HIGHEST)
        o = lanes[None, :] - oh_lo[:, None]
        v1 = jnp.sum(jnp.where(o == 0, w0, 0.0), axis=-1)
        v2 = jnp.sum(jnp.where(o == 1, w0, 0.0), axis=-1) + \
            jnp.sum(jnp.where(o == 1 - _LANE, w1, 0.0), axis=-1)
        return v1, v2

    if per_channel:
        v1, v2 = jax.vmap(mm)(hi, lo, win2)
    else:
        v1, v2 = jax.vmap(mm, in_axes=(None, None, 0))(hi, lo, win2)
    return v1 + (v2 - v1) * frac


def roll(win, writes):
    """Advance the rolling window by one sub-block: drop the oldest B
    frames, append ``writes`` [ch, B] as the newest."""
    b = writes.shape[-1]
    return jnp.concatenate([win[..., b:], writes.astype(win.dtype)], axis=-1)


def read_frac_win_grouped(win, offsets, slab_rows: int):
    """:func:`read_frac_win` with per-128-output-group dynamic row slabs.

    The plain window read builds a [B, W/128] one-hot and matmuls it
    against the WHOLE window — W-proportional MACs per step.  Read
    positions are ramps (|Δrel| <= 1 + |Δoffset|), so each 128-output
    group touches a narrow row band: slice ``slab_rows`` rows around the
    group's minimum row (dynamic_slice — cheap) and select within the
    slab, cutting MACs by W/(128*slab_rows).

    ``slab_rows`` must bound every group's row span; the caller derives
    it from the offset stream's maximum slew (e.g. the spring smoother's
    velocity bound).  Out-of-bound rels clamp to the slab edge — only
    reachable if the slew bound is violated.  Offsets: [B] shared across
    channels or [ch, B] per-channel."""
    ch, W = win.shape
    per_channel = jnp.asarray(offsets).ndim == 2
    b = jnp.asarray(offsets).shape[-1]
    ptype = win.dtype if jnp.issubdtype(win.dtype, jnp.floating) else jnp.float32
    offs = jnp.asarray(offsets).astype(ptype)
    oi = jnp.floor(offs)
    of = (offs - oi).astype(win.dtype)
    is_int = of == 0
    j = jnp.arange(b, dtype=jnp.int32)
    rel = W + j - oi.astype(jnp.int32) - jnp.where(is_int, 0, 1)
    frac = jnp.where(is_int, of, 1.0 - of)

    rows = W // _LANE
    sl = int(slab_rows)
    if (win.dtype == jnp.float64 or W % _LANE != 0 or b % _LANE != 0
            or sl >= rows):
        return read_frac_win(win, offsets)

    g = b // _LANE
    win2 = win.reshape(ch, rows, _LANE)
    rel_g = rel.reshape((-1, g, _LANE)) if per_channel else rel.reshape(g, _LANE)
    lanes = jnp.arange(_LANE, dtype=jnp.int32)
    rs = jnp.arange(sl, dtype=jnp.int32)

    def group(rel1, w2):
        # rel1: [LANE] this group's window-relative positions; w2 [rows,128]
        rmin = jnp.clip(jnp.min(rel1) >> 7, 0, rows - sl)
        slab = jax.lax.dynamic_slice(w2, (rmin, jnp.int32(0)), (sl, _LANE))
        rl = jnp.clip(rel1 - rmin * _LANE, 0, sl * _LANE - 2)
        hi = rl >> 7
        lo = rl & 127
        oh = (hi[:, None] == rs[None, :]).astype(w2.dtype)  # [128, sl]
        w0 = jnp.matmul(oh, slab, precision=jax.lax.Precision.HIGHEST)
        w1 = jnp.matmul(oh[:, :-1], slab[1:],
                        precision=jax.lax.Precision.HIGHEST)
        o = lanes[None, :] - lo[:, None]
        v1 = jnp.sum(jnp.where(o == 0, w0, 0.0), axis=-1)
        v2 = jnp.sum(jnp.where(o == 1, w0, 0.0), axis=-1) + \
            jnp.sum(jnp.where(o == 1 - _LANE, w1, 0.0), axis=-1)
        return v1, v2

    if per_channel:
        v1, v2 = jax.vmap(jax.vmap(group, in_axes=(0, None)))(rel_g, win2)
    else:
        v1, v2 = jax.vmap(lambda w2: jax.vmap(group, in_axes=(0, None))(
            rel_g, w2))(win2)
    v1 = v1.reshape(ch, b)
    v2 = v2.reshape(ch, b)
    return v1 + (v2 - v1) * frac
