"""Granular playback engine for the Sampler.

Behavioural spec: reference src/generator/sampler/granular.rs —
  * 8 window shapes in a 2048-entry LUT with lerp lookup (:112-215);
  * Cloud mode: density phase accumulator triggers grains (:788-809);
    Sequential mode: next grain at the primary grain's window crossfade
    point (:78-94, 541-555);
  * per-trigger randomisation: spray (+-1 s), variation -> volume 0..1 /
    size 25..400% / two +-0.5 st pitch draws, pan spread (:813-897);
  * grains advance analytically: normalized position += speed/file_len,
    window phase += 1/size, loop-range or global wrap (:1081-1120);
  * Catmull-Rom 4-point read with circular index wrap (:899-933);
  * playhead advances by step*(1+speed_mod)/file_len with a loop-entry
    latch (:605-640); linear (not constant-power) grain pan law (:715-718).

Formulation: a grain's whole evolution is analytic in its activation
parameters, so rendering is a fully vectorised [G, n] windowed gather — no
per-sample machinery.  Only trigger *allocation* is sequential (a grain must
land in a free slot), a short ``lax.scan`` over at most MAXT trigger
candidates per block (MAXT = ceil(max_density * block / sr) + 2, static).
RNG is deterministic counter hashing (the reference is OS-seeded).

Deviation: the playhead's loop-entry latch is evaluated per block with a
cumulative-entry approximation (fold once entered anywhere in the block);
exact per-sample latching would need a scan for a control signal that moves
<1 sample per block in practice.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.lfo import _hash_random

POOL_SIZE = 100  # grains per voice (voice.rs:33)
WINDOW_N = 2048
NEVER = np.iinfo(np.int32).max

WINDOW_MODES = ("Hann", "Blackman", "Triangle", "Tukey", "Trapezoid",
                "Exponential", "RampUp", "RampDown")
# sequential crossfade points per window (granular.rs:78-94)
CROSSFADE_POINTS = (0.5, 0.5, 0.5, 0.5, 0.9, 0.8, 0.8, 0.8)
DIRECTIONS = ("Forward", "Backward", "Random")
OVERLAP_MODES = ("Cloud", "Sequential")

# Grain pitch and read positions round alike on every platform: a read
# position is a normalized float32 times the source length, so one ulp
# moves a read by up to ~0.01 frames of a 96000-frame source, and a one-ulp
# difference in a grain's increment grows to that over a one-second grain.
# Platforms differ in exp2 and division (their math libraries) and in
# whether a product feeding a sum is fused into one multiply-add (one
# rounding instead of two); plain products and sums round alike everywhere.

# 2**(sem/12) for a grain's pitch draw |sem| < 1 semitone, as the degree-5
# Taylor polynomial (exact to float32 rounding there), highest term first.
_PITCH_COEFFS = tuple(float((np.log(2.0) / 12.0) ** k / np.prod(np.arange(1, k + 1)))
                      for k in range(5, -1, -1))


def _split_product(a, b):
    """``a * b`` (float32) as the sum of four partial products of 12 x 12
    significant bits.  Each is exact, so a platform that fuses a product
    into the add after it rounds the sums as one that does not."""
    def hi12(x):  # x with its low 12 mantissa bits cleared
        return jax.lax.bitcast_convert_type(
            jax.lax.bitcast_convert_type(x, jnp.int32) & jnp.int32(-4096),
            jnp.float32)

    a_hi, b_hi = hi12(a), hi12(b)
    a_lo, b_lo = a - a_hi, b - b_hi
    return (a_hi * b_hi + a_hi * b_lo) + (a_lo * b_hi + a_lo * b_lo)


def _pitch_ratio(sem):
    r = jnp.float32(_PITCH_COEFFS[0])
    for c in _PITCH_COEFFS[1:]:
        r = _split_product(r, sem) + jnp.float32(c)
    return r


@lru_cache(maxsize=1)
def grain_windows():
    """float32 [8, 2048] window LUTs (granular.rs:112-196)."""
    n = WINDOW_N
    phase = np.arange(n) / n
    luts = np.zeros((8, n), np.float32)
    luts[0] = 0.5 * (1.0 - np.cos(2 * np.pi * phase))  # Hann
    luts[1] = 0.42 - 0.5 * np.cos(2 * np.pi * phase) + 0.08 * np.cos(4 * np.pi * phase)
    luts[2] = np.where(phase < 0.5, 2 * phase, 2 * (1 - phase))  # Triangle
    w = 0.25  # Tukey alpha 0.5 -> width 0.25
    luts[3] = np.where(
        phase < w, 0.5 * (1 - np.cos(np.pi * phase / w)),
        np.where(phase > 1 - w, 0.5 * (1 - np.cos(np.pi * (1 - phase) / w)), 1.0),
    )
    rw = 0.1
    luts[4] = np.where(
        phase < rw, phase / rw, np.where(phase > 1 - rw, (1 - phase) / rw, 1.0)
    )
    luts[5] = np.exp(-6.0 * np.abs(phase - 0.5))  # Exponential (Poisson)
    luts[6] = np.where(
        phase < 0.9, phase / 0.9, 0.5 * (1 + np.cos(np.pi * (phase - 0.9) / 0.1))
    )
    luts[7] = np.where(
        phase < 0.1, 0.5 * (1 - np.cos(np.pi * phase / 0.1)), 1.0 - (phase - 0.1) / 0.9
    )
    return luts  # NumPy: safe to cache across jit traces


def window_sample(mode, phase, table=None):
    """Lerp LUT lookup (granular.rs:201-215).  mode int32[...], phase f32[...]
    ``table`` should be the device-resident flat window LUT (state pytree);
    passing it as an argument keeps it out of the compiled program."""
    idx_f = jnp.clip(phase, 0.0, 1.0) * (WINDOW_N - 1)
    idx = jnp.minimum(idx_f.astype(jnp.int32), WINDOW_N - 2)
    frac = idx_f - idx
    # flat gather: mode and phase share shape
    lin = jnp.asarray(mode, jnp.int32) * WINDOW_N
    if table is None:
        table = jnp.asarray(grain_windows().reshape(-1))
    a = table[lin + idx]
    b = table[lin + idx + 1]
    return a * (1.0 - frac) + b * frac


@dataclasses.dataclass
class GranularConfig:
    """Static granular options; the matching FourCC parameters modulate at
    runtime (sampler.rs:219-296).

    ``max_read_speed`` bounds a grain's source read rate (samples advanced
    per output sample; grain speeds above it clamp; deviation: the
    reference has no such cap)."""

    overlap_mode: str = "Cloud"
    window: str = "Hann"
    size_ms: float = 100.0
    density_hz: float = 10.0
    variation: float = 0.0
    spray: float = 0.0
    pan_spread: float = 0.0
    direction: str = "Forward"
    position: float = 0.5
    step: float = 0.0
    max_read_speed: float = 4.0


def catmull_rom_gather(mono_buf, fidx):
    """4-point Catmull-Rom read of fractional source frames ``fidx`` (any
    shape) from ``mono_buf`` [frames], taps wrapping on the file circle
    (granular.rs:899-933)."""
    frames = mono_buf.shape[0]
    i1 = jnp.minimum(fidx.astype(jnp.int32), frames - 1)
    frac = fidx - i1.astype(jnp.float32)
    i0 = jnp.where(i1 > 0, i1 - 1, frames - 1)
    i2 = jnp.where(i1 < frames - 1, i1 + 1, 0)
    i3 = jnp.where(i2 < frames - 1, i2 + 1, 0)
    y0, y1, y2, y3 = mono_buf[i0], mono_buf[i1], mono_buf[i2], mono_buf[i3]
    a = -0.5 * y0 + 1.5 * y1 - 1.5 * y2 + 0.5 * y3
    b = y0 - 2.5 * y1 + 2.0 * y2 - 0.5 * y3
    c = -0.5 * y0 + 0.5 * y2
    return ((a * frac + b) * frac + c) * frac + y1


def playhead_trajectory(playhead0, in_loop0, steps, loop_range):
    """Analytic playhead with the loop-entry latch (granular.rs:605-640).

    playhead0/in_loop0: scalars; steps: [n] per-sample normalized
    increments (already masked to the active region); loop_range:
    (on, start, end) traced scalars.  Returns (playhead [n], entered [n]).

    Module-docstring deviation lives here: ``entered`` latches on the
    prefix of the RAW (unfolded) trajectory's loop membership, and the
    folded branch folds that raw trajectory — exact per-sample latching
    would carry the folded value through a scan.  The two differ only when
    the raw trajectory leaves [start, end) again within the same block
    AFTER first entering it, i.e. when the playhead crosses
    ``end - start`` of normalized distance in one block; the worst-case
    error is pinned by tests/test_deviation_bounds.py."""
    ph_raw = playhead0 + jnp.cumsum(steps)
    loop_on = jnp.asarray(loop_range[0]) > 0.5
    ls = jnp.asarray(loop_range[1], jnp.float32)
    le = jnp.asarray(loop_range[2], jnp.float32)
    ll = jnp.maximum(le - ls, 1e-9)
    wrapped = jnp.mod(ph_raw, 1.0)
    in_range = (wrapped >= ls) & (wrapped < le) & loop_on
    entered = (jnp.cumsum(in_range.astype(jnp.int32)) > 0) | (in_loop0 > 0.5)
    entered = entered & loop_on
    folded = ls + jnp.mod(ph_raw - ls, ll)
    return jnp.where(entered, folded, wrapped), entered


def grain_state_init(pool: int = POOL_SIZE):
    z = lambda dt: jnp.zeros((pool,), dt)
    return {
        "g_trig": jnp.full((pool,), NEVER, jnp.int32),  # global trigger frame
        "g_dur": z(jnp.int32),
        "g_pos0": z(jnp.float32),
        "g_inc": z(jnp.float32),
        "g_wmode": z(jnp.int32),
        "g_winc": z(jnp.float32),
        "g_vol": z(jnp.float32),
        "g_pan": z(jnp.float32),
        "g_loop": z(jnp.float32),  # 1 = fold into loop range
        "trigger_phase": jnp.float32(1.0),  # start() arms an immediate trigger
        "playhead": jnp.float32(0.0),
        "in_loop": jnp.float32(0.0),
        "rng_count": jnp.int32(0),
        "seq_next": jnp.int32(0),  # sequential mode: next trigger frame (global)
    }


def granular_voice_alloc(
    state: dict,
    *,
    frame0,  # i32 scalar: global frame of block start
    n: int,
    sr: int,
    frames: int,  # source length in frames (positions fold on this circle)
    loop_range,  # traced (on, start_norm, end_norm) scalars; on<=0.5 = off
    note_start,  # i32 scalar: global frame of current note-on (resets pool)
    held,  # bool[n]: may trigger new grains (note held, pre-release)
    speed,  # f32[n]: effective voice speed (note * transpose * finetune)
    vol,  # f32[n]: effective voice volume (base * velocity)
    pan,  # f32[n]: effective voice panning
    # per-sample granular parameters (already smoothed), with modulation
    # offsets applied by the caller:
    size_ms, density, variation, spray, pan_spread, position, pos_mod, step, speed_mod,
    overlap_mode,  # i32 scalar: 0 cloud, 1 sequential
    window_mode,  # i32[n]
    window_table=None,  # f32[8*WINDOW_N] device-resident LUT
    direction,  # i32[n]
    seed: int,
    max_triggers: int,
    max_read_speed: float = 4.0,
):
    """Trigger/allocate/evolve one voice's grain pool for a block, up to
    (but excluding) the source read: returns
    ``(new_state, fidx [G, n], g [G, n])`` — per-grain read positions in
    source frames and the per-sample grain weights (window envelope x grain
    volume, gated by activity).  The read + pan mix live in
    :func:`granular_voice_block`."""
    file_dur_secs = frames / sr
    ii = jnp.arange(n, dtype=jnp.int32)
    gframes = frame0 + ii

    # --- note (re)start: reset pool bookkeeping at note_start ------------
    fresh = note_start > frame0 - 1  # note started at/after this block start
    restart_here = (note_start >= frame0) & (note_start < frame0 + n)
    trigger_phase = jnp.where(restart_here | (note_start == frame0), 1.0,
                              state["trigger_phase"])
    playhead0 = jnp.where(restart_here, position[jnp.maximum(note_start - frame0, 0)],
                          state["playhead"])
    in_loop0 = jnp.where(restart_here, 0.0, state["in_loop"])

    # --- playhead trajectory (granular.rs:605-640) ------------------------
    step_inc = step * (1.0 + speed_mod) / jnp.float32(frames)
    active_after_start = gframes >= note_start
    playhead, entered = playhead_trajectory(
        playhead0, in_loop0, jnp.where(active_after_start, step_inc, 0.0),
        loop_range)
    loop_on = jnp.asarray(loop_range[0]) > 0.5
    ls = jnp.asarray(loop_range[1], jnp.float32)
    le = jnp.asarray(loop_range[2], jnp.float32)
    ll = jnp.maximum(le - ls, 1e-9)
    in_loop_end = entered[-1].astype(jnp.float32)

    base_position = jnp.where(step == 0.0, position, playhead) + pos_mod

    # --- cloud-mode trigger times -----------------------------------------
    dens = jnp.clip(density, 1.0, 100.0)
    tp = trigger_phase + jnp.cumsum(jnp.where(active_after_start, dens / sr, 0.0))
    tp_prev = jnp.concatenate([jnp.reshape(trigger_phase, (1,)), tp[:-1]])
    # start() arms trigger_phase at exactly 1.0 so the first held sample
    # fires immediately (granular.rs:484) — that boundary case never crosses
    # a floor step, so force it
    armed = (ii == (jnp.maximum(note_start - frame0, 0))) & (trigger_phase >= 1.0)
    trig_mask = ((jnp.floor(tp) > jnp.floor(tp_prev)) | armed) & held & active_after_start
    cloud_times = jnp.sort(jnp.where(trig_mask, ii, n))[:max_triggers]
    new_trigger_phase = tp[-1] - jnp.floor(tp[-1])

    is_seq = overlap_mode == 1
    cf_points = jnp.asarray(CROSSFADE_POINTS, jnp.float32)

    # --- allocation scan over trigger candidates --------------------------
    def alloc_step(carry, k):
        slots, rng, seq_next = carry
        t_cloud = cloud_times[k]
        t_seq = jnp.clip(seq_next - frame0, 0, n)  # local
        t = jnp.where(is_seq, t_seq, t_cloud).astype(jnp.int32)
        t_safe = jnp.minimum(t, n - 1)
        valid = (t < n) & jnp.where(is_seq, held[t_safe] & (gframes[t_safe] >= note_start), True)

        gt = frame0 + t_safe  # global trigger frame

        def draw(i):
            return _hash_random(seed, rng * 8 + i)  # [-1, 1)

        u = lambda i: (draw(i) + 1.0) * 0.5  # [0, 1)

        var = jnp.clip(variation[t_safe], 0.0, 1.0)
        vol_scale = 1.0 - var * u(0)
        size_scale = (1.0 - 0.75 * var) + (2.75 * var) * u(2)
        size = jnp.clip(size_ms[t_safe], 1.0, 1000.0)
        dur = jnp.maximum((size * size_scale * sr / 1000.0).astype(jnp.int32), 2)
        pspread = jnp.clip(pan_spread[t_safe], 0.0, 1.0)
        gpan = jnp.clip(pan[t_safe] + pspread * draw(3), -1.0, 1.0)
        # the two pitch draws, +-var/2 semitones each
        sem = var * ((u(1) - 0.5) + draw(4) * 0.5)
        d = direction[t_safe]
        reverse = jnp.where(d == 0, False, jnp.where(d == 1, True, draw(5) > 0.0))
        spr = jnp.clip(spray[t_safe], 0.0, 1.0)
        spray_off = spr * draw(6) / jnp.float32(file_dur_secs)

        gpos = base_position[t_safe] + spray_off
        lm = entered[t_safe]
        gpos = jnp.where(lm, ls + jnp.mod(gpos - ls, ll), gpos)
        gpos = jnp.mod(gpos, 1.0)

        # read-speed cap (GranularConfig.max_read_speed; deviation — no cap
        # in the reference)
        gspeed = jnp.minimum(speed[t_safe] * _pitch_ratio(sem),
                             jnp.float32(max_read_speed))
        ginc = gspeed / jnp.float32(frames) * jnp.where(reverse, -1.0, 1.0)
        gvol = jnp.clip(vol[t_safe] * vol_scale, 0.0, 100.0)
        wm = window_mode[t_safe]
        winc = 1.0 / dur.astype(jnp.float32)

        # first free slot (granular.rs:823).  Unlike the reference (which
        # renders per sample), we render the whole block AFTER allocation,
        # so a slot is only reusable if its grain expired BEFORE this block —
        # otherwise the overwrite would erase an unrendered grain.
        free = (slots["g_trig"] == NEVER) | (slots["g_trig"] + slots["g_dur"] <= frame0)
        any_free = jnp.any(free)
        idx = jnp.argmax(free)
        do = valid & any_free

        def put(arr, v):
            return arr.at[idx].set(jnp.where(do, v, arr[idx]))

        slots = {
            "g_trig": put(slots["g_trig"], gt),
            "g_dur": put(slots["g_dur"], dur),
            "g_pos0": put(slots["g_pos0"], gpos),
            "g_inc": put(slots["g_inc"], ginc),
            "g_wmode": put(slots["g_wmode"], wm),
            "g_winc": put(slots["g_winc"], winc),
            "g_vol": put(slots["g_vol"], gvol),
            "g_pan": put(slots["g_pan"], gpan),
            "g_loop": put(slots["g_loop"],
                          lm.astype(jnp.float32) if loop_range is not None else 0.0),
        }
        rng = rng + jnp.where(valid, 1, 0)
        # sequential: chain the next trigger at the crossfade point
        cf = cf_points[jnp.clip(wm, 0, 7)]
        seq_step = jnp.maximum((cf / winc).astype(jnp.int32), 1)
        seq_next = jnp.where(is_seq & do, gt + seq_step,
                             jnp.where(is_seq & valid, seq_next + 1, seq_next))
        return (slots, rng, seq_next), None

    slot_keys = ("g_trig", "g_dur", "g_pos0", "g_inc", "g_wmode", "g_winc",
                 "g_vol", "g_pan", "g_loop")
    slots0 = {k: state[k] for k in slot_keys}
    seq_next0 = jnp.where(
        (state["seq_next"] < frame0) | fresh, jnp.maximum(note_start, frame0),
        state["seq_next"],
    )
    (slots, rng_count, seq_next), _ = jax.lax.scan(
        alloc_step, (slots0, state["rng_count"], seq_next0),
        jnp.arange(max_triggers, dtype=jnp.int32),
    )

    # --- render all grain slots [G, n] -------------------------------------
    local = gframes[None, :] - slots["g_trig"][:, None]  # [G, n]
    g_active = (local >= 0) & (local < slots["g_dur"][:, None])
    # hard-cut grains of the previous note at a steal (voice reset)
    g_active &= ~((slots["g_trig"][:, None] < note_start) & (gframes[None, :] >= note_start))

    localf = local.astype(jnp.float32)
    wphase = jnp.clip(localf * slots["g_winc"][:, None], 0.0, 1.0)
    env = window_sample(
        jnp.broadcast_to(slots["g_wmode"][:, None], wphase.shape), wphase,
        table=window_table)
    env = env * slots["g_vol"][:, None]

    pos = slots["g_pos0"][:, None] + _split_product(localf, slots["g_inc"][:, None])
    pos_folded = ls + jnp.mod(pos - ls, ll)
    looped = slots["g_loop"][:, None] > 0.5
    pos = jnp.where(looped, pos_folded, jnp.mod(pos, 1.0))
    fidx = pos * jnp.float32(frames - 1)

    ENVELOPE_THRESHOLD = 1e-5
    g = jnp.where(g_active & (env > ENVELOPE_THRESHOLD), env, 0.0)

    new_state = dict(slots)
    new_state.update({
        "trigger_phase": jnp.where(jnp.any(held), new_trigger_phase, trigger_phase),
        "playhead": playhead[-1],
        "in_loop": in_loop_end,
        "rng_count": rng_count,
        "seq_next": seq_next,
    })
    return new_state, fidx, g


def grain_mix(s, g, g_pan):
    """Weighted equal-power-less pan mix of grain streams: s [G, n] source
    reads, g [G, n] grain weights, g_pan [G] -> [2, n]
    (granular.rs:933-941).

    The pan-weighted sums are one [2, G] @ [G, n] matmul at HIGHEST
    precision (no TF32); summation order differs from a sequential sum by
    ulps only."""
    windowed = s * g
    w = jnp.stack([(1.0 - g_pan) * 0.5, (1.0 + g_pan) * 0.5])  # [2, G]
    return jnp.matmul(w, windowed,
                      precision=jax.lax.Precision.HIGHEST)


def granular_voice_block(
    state: dict,
    *,
    frame0,
    n: int,
    sr: int,
    mono_buf,  # [frames] f32 (wraps circularly; no guard frames)
    loop_range,
    note_start,
    held, speed, vol, pan,
    size_ms, density, variation, spray, pan_spread, position, pos_mod, step,
    speed_mod, overlap_mode, window_mode, window_table=None, direction=None,
    seed: int = 0,
    max_triggers: int = 8,
    max_read_speed: float = 4.0,
):
    """Render one voice's granular output for a block -> (state, [2, n]).

    Composition of :func:`granular_voice_alloc`, the Catmull-Rom gather
    read, and :func:`grain_mix`."""
    frames = mono_buf.shape[0]
    new_state, fidx, g = granular_voice_alloc(
        state, frame0=frame0, n=n, sr=sr, frames=frames,
        loop_range=loop_range, note_start=note_start, held=held, speed=speed,
        vol=vol, pan=pan, size_ms=size_ms, density=density,
        variation=variation, spray=spray, pan_spread=pan_spread,
        position=position, pos_mod=pos_mod, step=step, speed_mod=speed_mod,
        overlap_mode=overlap_mode, window_mode=window_mode,
        window_table=window_table, direction=direction, seed=seed,
        max_triggers=max_triggers, max_read_speed=max_read_speed)

    # Catmull-Rom read with circular wrap (granular.rs:899-933)
    s = catmull_rom_gather(mono_buf, fidx)
    return new_state, grain_mix(s, g, new_state["g_pan"])
