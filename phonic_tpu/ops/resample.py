"""Resampling: 4-point Hermite (default) and polyphase windowed-sinc (HQ).

Behavioural spec:
  - default quality: reference src/utils/resampler/cubic.rs — 4-point
    3rd-order Hermite x-form (Niemitalo, deip.pdf p. 43, :121-142)
  - high quality: reference src/utils/resampler/rubato.rs — bandlimited sinc
    via the rubato crate; reimplemented here as a polyphase Kaiser-windowed
    sinc FIR (a gather + small dot product)

Design difference from the reference (intentional): the reference streams
through stateful per-channel interpolators with push/consume bookkeeping; on
an accelerator every output sample's source position is computed *analytically*
(`pos[j] = pos0 + cumsum(step)`), so an arbitrarily speed-glided, looped read
becomes one vectorised gather + polynomial per block.  The reference's two
stream branches differ by a one-sample latency quirk
(src/utils/resampler/cubic.rs:71-112); we use the zero-offset positional
definition everywhere.

Out-of-range positions read zeros (the reference zero-pads at EOF,
src/source/resampled.rs:104-152, and appends one guard frame to every
preloaded buffer, src/source/file/buffer.rs:103-105).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp


def hermite_read(buf, positions, fill=0.0):
    """Read fractional ``positions`` from ``buf`` with 4-point Hermite
    interpolation.

    buf: [..., frames] (channels lead); positions: [n] (or broadcastable to
    buf's batch dims + [n]).  Positions outside [0, frames-1] produce
    ``fill`` contributions from the missing taps.
    """
    buf = jnp.asarray(buf)
    frames = buf.shape[-1]
    pos = jnp.asarray(positions, jnp.float32)
    k = jnp.floor(pos)
    frac = (pos - k).astype(buf.dtype)
    ki = k.astype(jnp.int32)

    def tap(offset):
        idx = ki + offset
        valid = (idx >= 0) & (idx < frames)
        safe = jnp.clip(idx, 0, frames - 1)
        v = jnp.take(buf, safe, axis=-1)
        return jnp.where(valid, v, jnp.asarray(fill, buf.dtype))

    ym1, y0, y1, y2 = tap(-1), tap(0), tap(1), tap(2)
    # Niemitalo x-form coefficients (src/utils/resampler/cubic.rs:128-141)
    c0 = y0
    c1 = (y1 - ym1) * 0.5
    c2 = ym1 - y0 * 2.5 + y1 * 2.0 - y2 * 0.5
    c3 = (y2 - ym1) * 0.5 + (y0 - y1) * 1.5
    return ((c3 * frac + c2) * frac + c1) * frac + c0


def catmull_rom_read(buf, positions, fill=0.0):
    """Alias: the granular engine's 4-point read
    (src/generator/sampler/granular.rs:899-933) uses the same Hermite
    x-form."""
    return hermite_read(buf, positions, fill)


# ---------------------------------------------------------------------------
# Gather-free Hermite read: one-hot matmuls
# ---------------------------------------------------------------------------
#
# The one-hot formulation replaces the gather (jnp.take over computed
# indices) with two one-hot row-matmuls: the buffer is packed
# into [R, 128, ch] rows; for each output chunk a [C, R-1] one-hot selects
# rows hi and hi+1 (two matmuls against consecutive row views), giving a
# [C, 256, ch] window that contains all four Hermite taps; the taps are
# then combined with a masked per-tap weight matrix.  One-hot
# matmuls at Precision.HIGHEST are EXACT in f32 (1.0 * x with bf16x3
# decomposition reconstructs x bit-exactly; 0.0 terms stay 0), so the only
# deviation from `hermite_read` is the tap-combination rounding order
# (x-form Horner vs per-tap weights), well below -120 dB.

MM_PAD_LEFT = 4  # zero frames packed before sample 0 (covers taps of pos>=-4)

# Rows are packed at stride MM_STRIDE < 128 so they OVERLAP by 4 samples:
# all four Hermite taps of any position then live inside ONE row, which
# halves the matmul bill (one row-select instead of the r/r+1 pair) and
# shrinks the tap-combination epilogue from a 256-wide to a 128-wide pass.
MM_STRIDE = 124

# The per-chunk one-hot is a materialized [chunk, R] f32 matrix and the
# row-matmul is linear in R, while the gather it replaces is O(n) in
# positions and independent of buffer length — so above a row threshold the
# matmul loses (and its transients grow unboundedly: R~62k for a 3-minute
# 44.1 kHz file would mean ~0.5 GB per 2048-chunk).  The row cap is a
# break-even inherited from an earlier accelerator and has not been
# re-derived for the GPU (see ROADMAP.md).
MM_MAX_ROWS = 3072  # ~7.9 s of 48 kHz audio


def mm_rows(frames: int, pad_left: int = MM_PAD_LEFT) -> int:
    """Packed row count :func:`mm_pack` produces for a ``frames``-long buffer."""
    return -(-(pad_left + int(frames) + 3) // MM_STRIDE) + 1


def use_mm(frames: int) -> bool:
    """Whether the gather-free one-hot read is used for this buffer length
    (callers fall back to :func:`hermite_read` above the threshold)."""
    return mm_rows(frames) <= MM_MAX_ROWS


def length_bucket(frames: int) -> int:
    """Coarse log2 length bucket for batch grouping: lanes in a group
    zero-pad to the group's longest buffer, so grouping a minutes-long lane
    with one-second lanes would multiply memory/FLOPs across the group.
    Everything under 64k frames (~1.4 s @ 48 kHz — where padding is cheap)
    shares bucket 0; beyond that, log2 buckets bound the waste to <2x."""
    return max(int(frames).bit_length() - 16, 0)


def mm_pack(buf, pad_left: int = MM_PAD_LEFT):
    """Host-side packing for :func:`hermite_read_mm`.

    buf: [..., ch, frames] float array.  Returns float32
    [..., R, 128, ch]: 128-wide rows at stride :data:`MM_STRIDE` (4-sample
    overlap, so any tap quad fits one row), ``pad_left`` zero frames before
    sample 0, zero padding past the end.
    """
    a = np.asarray(buf, np.float32)
    frames = a.shape[-1]
    r = mm_rows(frames, pad_left)
    flat = np.zeros(a.shape[:-1] + ((r - 1) * MM_STRIDE + 128,), np.float32)
    flat[..., pad_left:pad_left + frames] = a
    idx = np.arange(r)[:, None] * MM_STRIDE + np.arange(128)[None, :]
    out = flat[..., idx]  # [..., ch, R, 128]
    return np.ascontiguousarray(np.moveaxis(out, -3, -1))  # [..., R, 128, ch]


def hermite_read_mm(bufmm, positions, chunk: int = 2048,
                    pad_left: int = MM_PAD_LEFT):
    """4-point Hermite read of fractional ``positions`` from an
    :func:`mm_pack`-packed buffer, computed without gathers (see module
    comment).  Positions may be arbitrary (loops / reverse / random grain
    access); out-of-range positions contribute zeros, matching
    ``hermite_read(buf, positions)`` with the default ``fill=0.0``.

    bufmm: [R, 128, ch]; positions: [n].  Returns [ch, n].
    """
    r = bufmm.shape[-3]
    ch = bufmm.shape[-1]
    pos = jnp.asarray(positions, jnp.float32)
    n = pos.shape[-1]
    k = jnp.floor(pos)
    frac = pos - k
    kil = k.astype(jnp.int32) - 1 + pad_left  # leftmost tap, packed index
    lim = MM_STRIDE * (r - 1) + 124  # all 4 taps stay inside the last row
    valid = (kil >= 0) & (kil <= lim)
    kil = jnp.clip(kil, 0, lim)

    c = int(min(chunk, n))
    npad = -(-n // c) * c
    if npad != n:
        kil = jnp.pad(kil, (0, npad - n))
        frac = jnp.pad(frac, (0, npad - n))
    nc = npad // c
    flat = bufmm.reshape(r, 128 * ch)
    rows = jnp.arange(r, dtype=jnp.int32)
    taps = jnp.arange(128, dtype=jnp.int32)

    def body(args):
        kil_c, frac_c = args  # [C]
        hi = kil_c // MM_STRIDE
        lo = kil_c - hi * MM_STRIDE  # 0..123; taps lo..lo+3 inside the row
        oh = (hi[:, None] == rows).astype(flat.dtype)  # [C, R]
        win = jnp.matmul(oh, flat,
                         precision=jax.lax.Precision.HIGHEST)  # [C, 128*ch]
        o = taps[None, :] - lo[:, None]  # [C, 128]
        f = frac_c[:, None]
        f2 = f * f
        f3 = f2 * f
        # per-tap weights of the Niemitalo x-form (sum to 1 at any f)
        w_m1 = f2 - 0.5 * (f + f3)
        w_y0 = 1.0 - 2.5 * f2 + 1.5 * f3
        w_y1 = 0.5 * f + 2.0 * f2 - 1.5 * f3
        w_y2 = 0.5 * (f3 - f2)
        w = (jnp.where(o == 0, w_m1, 0.0) + jnp.where(o == 1, w_y0, 0.0)
             + jnp.where(o == 2, w_y1, 0.0) + jnp.where(o == 3, w_y2, 0.0))
        return jnp.sum(w[:, :, None] * win.reshape(c, 128, ch),
                       axis=1)  # [C, ch] (exact f32)

    outs = jax.lax.map(body, (kil.reshape(nc, c), frac.reshape(nc, c)))
    out = outs.reshape(npad, ch)[:n]
    out = jnp.where(valid[:, None], out, 0.0)
    return out.T


# ---------------------------------------------------------------------------
# Two-stage two-window one-hot read: the ramp-structured fast path
# ---------------------------------------------------------------------------
#
# `hermite_read_mm` streams the WHOLE packed buffer through the matmul per
# chunk (selection-by-matmul costs C x R x 128 MACs).  When consecutive
# positions within a chunk step by at most `smax` samples, the chunk only
# touches ~chunk*smax source samples, so the selection goes two-stage:
#   stage 1  fetch two NR-row windows (chunk-min and chunk-max anchored)
#            with a [2NR, R] one-hot row-select (2NR x R x 128 MACs);
#   stage 2  the usual one-hot read against the 2NR-row window
#            (C x 2NR x 128 MACs).
# Mod-fold jumps (loops, circular wraps, repeat folds) are EXACT: after a
# fold jump positions land within chunk*smax of the fold interval's other
# end, so a chunk's positions always occupy at most two bands — one inside
# each window.  The read is bound by the 128-lane tap-select epilogue, so
# the second window is nearly free and this variant beats hermite_read_mm
# whenever R >> 2NR.

# mm2's stage-1 cost is linear in R with a tiny constant (2NR row-selects).
# The cap bounds stage 1's streaming of the packed buffer per chunk; like
# MM_MAX_ROWS it is an inherited break-even, not one measured on the GPU.
MM2_MAX_ROWS = 16384


def use_mm2(frames: int) -> bool:
    """Whether the two-stage one-hot read is used for this buffer length."""
    return mm_rows(frames) <= MM2_MAX_ROWS


def speed_bucket(max_step: float) -> int:
    """Static power-of-two bucket exponent for a per-sample position step
    bound: smax = 2**bucket >= max_step.  Callers encode the bucket in a
    lowered input's SHAPE so a growing bound retraces the step program
    (one planned retrace per growth) instead of recompiling per value."""
    m = max(float(max_step), 1e-6)
    # exact powers of two stay in their own bucket (smax bounds INCLUSIVE:
    # the in-graph step clamp at smax is then a no-op for in-contract speeds)
    return int(min(max(math.ceil(math.log2(m) - 1e-9), 0), 6))


def hermite_read_mm2(bufmm, positions, smax: float, chunk: int = 2048,
                     pad_left: int = MM_PAD_LEFT):
    """4-point Hermite read of ``positions`` from an :func:`mm_pack`-packed
    buffer via the two-stage two-window one-hot (see block comment).

    Exact equivalent of ``hermite_read(buf, positions)`` provided
    ``|positions[i+1] - positions[i]| <= smax`` within each chunk, except
    at mod-fold jumps (which are handled exactly).  Callers must clamp
    their per-sample steps to ``smax`` (the speed-bucket contract).

    bufmm: [R, 128, ch]; positions: [n].  Returns [ch, n].
    """
    r = bufmm.shape[-3]
    ch = bufmm.shape[-1]
    pos = jnp.asarray(positions, jnp.float32)
    n = pos.shape[-1]
    c = int(min(chunk, n))
    nr = (c * int(math.ceil(smax)) + 260) // MM_STRIDE + 2
    if r <= 2 * nr + 2:  # window overhead >= buffer: single full window
        return hermite_read_mm(bufmm, positions, chunk, pad_left)

    k = jnp.floor(pos)
    frac = pos - k
    kil = k.astype(jnp.int32) - 1 + pad_left
    lim = MM_STRIDE * (r - 1) + 124
    valid = (kil >= 0) & (kil <= lim)
    kil = jnp.clip(kil, 0, lim)

    npad = -(-n // c) * c
    if npad != n:
        kil = jnp.pad(kil, (0, npad - n))
        frac = jnp.pad(frac, (0, npad - n))
    nc = npad // c
    flat = bufmm.reshape(r, 128 * ch)
    rows = jnp.arange(r, dtype=jnp.int32)
    nri = jnp.arange(nr, dtype=jnp.int32)
    taps = jnp.arange(128, dtype=jnp.int32)

    def body(args):
        kil_c, frac_c = args  # [C]
        alo = jnp.clip(jnp.min(kil_c) // MM_STRIDE, 0, r - nr)
        ahi = jnp.clip(jnp.max(kil_c) // MM_STRIDE - (nr - 1), 0, r - nr)
        oh1 = (jnp.concatenate([alo + nri, ahi + nri])[:, None]
               == rows[None, :]).astype(flat.dtype)  # [2nr, R]
        w1 = jnp.matmul(oh1, flat,
                        precision=jax.lax.Precision.HIGHEST)  # [2nr, 128*ch]
        in_lo = kil_c < (alo + nr) * MM_STRIDE
        base = jnp.where(in_lo, alo, ahi - nr)
        kil2 = kil_c - base * MM_STRIDE
        hi = kil2 // MM_STRIDE
        lo = kil2 - hi * MM_STRIDE
        oh = (hi[:, None] == jnp.arange(2 * nr, dtype=jnp.int32)[None, :]
              ).astype(flat.dtype)  # [C, 2nr]
        win = jnp.matmul(oh, w1, precision=jax.lax.Precision.HIGHEST)
        o = taps[None, :] - lo[:, None]  # [C, 128]
        f = frac_c[:, None]
        f2 = f * f
        f3 = f2 * f
        w_m1 = f2 - 0.5 * (f + f3)
        w_y0 = 1.0 - 2.5 * f2 + 1.5 * f3
        w_y1 = 0.5 * f + 2.0 * f2 - 1.5 * f3
        w_y2 = 0.5 * (f3 - f2)
        w = (jnp.where(o == 0, w_m1, 0.0) + jnp.where(o == 1, w_y0, 0.0)
             + jnp.where(o == 2, w_y1, 0.0) + jnp.where(o == 3, w_y2, 0.0))
        return jnp.sum(w[:, :, None] * win.reshape(c, 128, ch), axis=1)

    outs = jax.lax.map(body, (kil.reshape(nc, c), frac.reshape(nc, c)))
    out = outs.reshape(npad, ch)[:n]
    out = jnp.where(valid[:, None], out, 0.0)
    return out.T


# ---------------------------------------------------------------------------
# Polyphase windowed sinc (HQ)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=32)
def sinc_table(taps: int = 32, phases: int = 512, cutoff: float = 1.0, beta: float = 9.0):
    """Kaiser-windowed sinc prototype, tabulated per fractional phase.

    Returns float32 [phases + 1, taps]; row p is the FIR for fractional
    position p/phases.  ``cutoff`` (0..1, fraction of the *output* Nyquist)
    must be set to ~1/ratio when downsampling for anti-aliasing.
    """
    half = taps // 2
    # tap k of phase p reads input[floor(pos) - half + 1 + k]; its distance
    # to the read position is (k - half + 1 - p/phases)
    p = np.arange(phases + 1)[:, None] / phases
    k = np.arange(taps)[None, :]
    x = k - half + 1.0 - p  # tap distance to the read position, in [-half, half]
    window = np.kaiser(2 * half * phases + 1, beta)
    wi = np.clip(np.round(x * phases).astype(np.int64) + half * phases, 0, len(window) - 1)
    h = cutoff * np.sinc(cutoff * x) * window[wi]
    h /= h.sum(axis=1, keepdims=True)  # unity DC gain per phase
    return jnp.asarray(h, jnp.float32)


def sinc_read(buf, positions, table, fill=0.0):
    """Bandlimited read of fractional ``positions`` using a polyphase table
    from :func:`sinc_table`.  Linear interpolation between adjacent phase
    rows gives continuously-variable fractional delay."""
    buf = jnp.asarray(buf)
    frames = buf.shape[-1]
    taps = table.shape[1]
    phases = table.shape[0] - 1
    half = taps // 2

    pos = jnp.asarray(positions, jnp.float32)
    k = jnp.floor(pos)
    frac = pos - k
    ki = k.astype(jnp.int32)

    ph = frac * phases
    p0 = jnp.floor(ph).astype(jnp.int32)
    pf = (ph - p0).astype(buf.dtype)
    h = table[p0] * (1.0 - pf[..., None]) + table[jnp.clip(p0 + 1, 0, phases)] * pf[..., None]

    # gather [n, taps] input windows
    idx = ki[..., None] + (jnp.arange(taps, dtype=jnp.int32) - half + 1)
    valid = (idx >= 0) & (idx < frames)
    safe = jnp.clip(idx, 0, frames - 1)
    v = jnp.take(buf, safe, axis=-1)
    v = jnp.where(valid, v, jnp.asarray(fill, buf.dtype))
    return jnp.sum(v * h, axis=-1)


def resample_positions(n_out: int, ratio, pos0=0.0):
    """Source positions for a fixed-ratio conversion: pos[j] = pos0 + j*ratio."""
    return jnp.asarray(pos0, jnp.float32) + jnp.arange(n_out, dtype=jnp.float32) * jnp.asarray(
        ratio, jnp.float32
    )


def glide_positions(steps, pos0=0.0):
    """Source positions for speed-glided playback: exclusive cumsum of
    per-output-sample steps (step = speed * in_rate / out_rate).  Returns
    (positions[n], end_pos)."""
    steps = jnp.asarray(steps, jnp.float32)
    csum = jnp.cumsum(steps)
    pos = jnp.asarray(pos0, jnp.float32) + jnp.concatenate(
        [jnp.zeros((1,), jnp.float32), csum[:-1]]
    )
    return pos, jnp.asarray(pos0, jnp.float32) + csum[-1]


def loop_fold(positions, loop_start, loop_end, mode: str = "forward"):
    """Fold linear positions into a loop range.

    forward:   start + (p - start) mod len        (wraps back to loop start)
    pingpong:  triangle fold between start and end.
    Positions before loop_start pass through unchanged (first pass).
    """
    p = jnp.asarray(positions, jnp.float32)
    start = jnp.asarray(loop_start, jnp.float32)
    end = jnp.asarray(loop_end, jnp.float32)
    length = jnp.maximum(end - start, 1e-6)
    rel = p - start
    if mode == "forward":
        folded = start + jnp.mod(rel, length)
    elif mode == "pingpong":
        cycle = jnp.mod(rel, 2.0 * length)
        folded = start + jnp.where(cycle < length, cycle, 2.0 * length - cycle)
    else:
        raise ValueError(f"unknown loop mode {mode!r}")
    return jnp.where(p < start, p, folded)
