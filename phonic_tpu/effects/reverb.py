"""Stereo reverb (Airwindows-style vibrato'd Householder FDN).

Behavioural spec: reference src/effect/reverb.rs — signal path per sample:
predelay -> lowpass biquad A (Q 1.618) -> *wet -> sin() -> 4 cascaded
Schroeder allpasses (g=0.5, prime-ish sizes 43/41/37/31 * size) -> 8
vibrato-modulated feedback delay lines (79..47 * size) cross-coupled in two
Householder-like 4-groups -> mean -> lowpass B (Q 0.618) -> clamp -> asin()
-> lowpass C (Q 0.5) -> + dry.  ROOM_SIZE maps to size = room^2*75+25,
blend/regen/cutoff derive from it (:408-420); two parameters only
(ROOM_SIZE, WET).

Formulation: the three lowpass biquads run as whole-block parallel
scans; the four allpasses chain inside one sub-block feedback scan (w[n] =
x[n] - 0.5*w[n-d]); the 8 FDN lines batch into one sub-block scan.  All
delay-line storage uses an ABSOLUTE-TIME block buffer (history ++ this
block's writes), so writes are one contiguous dynamic_update_slice per
step and reads are contiguous dynamic_slice windows — no modulo rings, no
per-element gathers or scatters.  The fractional vibrato read
resolves through a 15-way shift-select over the window (offset range is
[0, 2*VIB_DEPTH]), which picks the exact same f32 values a gather would.

Note on feedback latency: the reference calls step() (count advance +
vibrato) between set() and get(), so reads always target slots written at
least period-16 samples ago — the FDN is exactly block-decomposable with
sub-blocks of min_line_delay - 17 samples.

Deliberate deviations from the reference:
  * line delays follow room-size automation at block rate, not sample rate
    (integer delay-size jumps are stepwise in the reference too);
  * the denormal-guard noise injection (|x| < 1.18e-23, reverb.rs:95-103)
    is dropped — XLA flushes float32 denormals to zero;
  * vibrato phases are seeded deterministically (reference: OS random).
"""

from __future__ import annotations

import math

import numpy as np
import jax
import jax.numpy as jnp

from ..graph.nodes import BuildCtx, Effect
from ..ops import filters
from ..ops import ring as ring_ops
from ..params import FloatParameter, format_percent

ROOM_SIZE = FloatParameter("room", "Room Size", 0.0, 1.0, 0.6,
                           formatter=format_percent, smoothing="linear")
WET = FloatParameter("wet ", "Wet", 0.0, 1.0, 0.35, formatter=format_percent)

# FDN line delay factors * size, and per-line vibrato depths (reverb.rs:105-151)
_LINE_FACTORS = np.array([79.0, 73.0, 71.0, 67.0, 61.0, 59.0, 53.0, 47.0])
_VIB_DEPTHS = np.array([0.003251, 0.002999, 0.002917, 0.002749,
                        0.002503, 0.002423, 0.002146, 0.002088])
_AP_FACTORS = np.array([43.0, 41.0, 37.0, 31.0])
_PRE_FACTOR = 29.0
VIB_SPEED = 0.1
VIB_DEPTH = 7.0

# Delay storage is sized per instance from the max_room_size capacity hint
# (pow2 of max line 79*size_cap+1 / allpass 43*size_cap+1, predelay
# 29*size_cap+2); the default capacity 1.0 gives 8192/8192/2902.


class ReverbEffect(Effect):
    PARAMS = (ROOM_SIZE, WET)
    WEIGHT = 5

    def __init__(self, room_size: float = 0.6, wet: float = 0.35,
                 seed: int = 0xA1B2, max_room_size: float = 1.0,
                 min_room_size: float = 0.0, name=None):
        super().__init__(name)
        self.room_size = float(room_size)
        self.wet = float(wet)
        self.seed = seed
        self._resets: list[int] = []
        # capacity hint (like DelayEffect.max_delay_capacity_ms): delay-line
        # storage is sized for the largest ROOM_SIZE this instance will ever
        # be automated to; the room parameter is clamped to it in-graph
        if not (0.0 < max_room_size <= 1.0):
            raise ValueError(f"max_room_size out of (0, 1]: {max_room_size}")
        if float(room_size) > float(max_room_size):
            raise ValueError("room_size exceeds max_room_size capacity")
        self.max_room_size = float(max_room_size)
        # floor hint (mirror of max_room_size): promising ROOM_SIZE never
        # automates BELOW this raises the minimum reachable delay, letting
        # the feedback scans run fewer, larger sub-blocks (the recurrence
        # stages are op-count-bound, so step count is the cost)
        if not (0.0 <= min_room_size <= float(room_size)):
            raise ValueError("min_room_size must be in [0, room_size]")
        self.min_room_size = float(min_room_size)
        size_cap = self.max_room_size ** 2 * 75.0 + 25.0
        self._line_buf = 1 << int(79.0 * size_cap + 1).bit_length()
        self._ap_buf = 1 << int(43.0 * size_cap + 1).bit_length()
        self._pre_max = int(_PRE_FACTOR * size_cap) + 2

    def reset(self, time: int = 0):
        """Flush all delay lines at block granularity
        (reference: ReverbEffectMessage::Reset, reverb.rs:470-494)."""
        self._resets.append(int(time))

    def handle_message(self, message, time: int = 0):
        if message in ("reset", ("reset",)):
            self.reset(time)
        else:
            raise ValueError(f"unknown reverb message {message!r}")

    def lower_block_inputs(self, block_start: int, block_len: int):
        hit = any(block_start <= t < block_start + block_len
                  for t in self._resets)
        # Prune consumed resets: entries otherwise accumulate for the node's
        # lifetime and a past reset would re-fire if the same range is ever
        # re-lowered after a seek.
        self._resets = [t for t in self._resets if t >= block_start + block_len]
        return {"_reset": np.float32(1.0 if hit else 0.0)}

    def param_initials(self):
        return {ROOM_SIZE.id: self.room_size, WET.id: self.wet}

    def batch_key(self, ctx: BuildCtx):
        # process() reads no per-instance statics beyond the buffer capacity
        # (a state SHAPE): instances with equal capacity trace identically
        # and can share one vmapped run
        return (type(self).__name__, self._line_buf, self._ap_buf,
                self._pre_max, self._subblocks(ctx))

    def init_state(self, ctx: BuildCtx):
        rng = np.random.default_rng(self.seed)
        dt = ctx.scan_dtype
        # phases carry in scan_dtype: in strict (float64) mode the vibrato
        # trajectory is then block-size-invariant to round-off — per-block
        # f32 phase accumulation was the dominant cross-block-size seam
        # (the recirculating FDN amplifies 1e-7 phase deltas to ~-70 dB)
        vib_phase = rng.uniform(0.0, 2.0 * math.pi, size=(8, 2)).astype(
            np.float32).astype(dt)
        # all delay buffers are chronological history windows (newest sample
        # last), NOT rings: process() concatenates them with the block's
        # writes so every read is a contiguous dynamic_slice
        return {
            "pre": jnp.zeros((2, self._pre_max), dt),
            "bq_a": filters.tpt_state_init((2,), dtype=dt),
            "bq_b": filters.tpt_state_init((2,), dtype=dt),
            "bq_c": filters.tpt_state_init((2,), dtype=dt),
            "ap_buf": jnp.zeros((4, 2, self._ap_buf), dt),
            "line_buf": jnp.zeros((8, 2, self._line_buf), dt),
            "vib_phase": jnp.asarray(vib_phase),
            "fb": jnp.zeros((8, 2), dt),
        }

    @staticmethod
    def _tail_for_room(room: float, sample_rate: int) -> int:
        """reference: reverb.rs:449-467."""
        size = room * room * 75.0 + 25.0
        max_delay = int(79.0 * size)
        fb = 1.0 - (1.0 - (0.82 - ((1.0 - room) * 0.7 + size * 0.002))) ** 4
        if fb >= 1.0:
            return int(20 * sample_rate)
        if fb <= 0.0:
            return max_delay
        return max_delay + int(max_delay * math.log10(0.001) / math.log10(fb))

    def tail_frames(self, ctx: BuildCtx) -> int:
        return self._tail_for_room(self.room_size, ctx.sample_rate)

    def max_tail_frames(self, ctx: BuildCtx) -> int:
        # ROOM_SIZE is automatable up to the capacity cap; the analytic decay
        # is monotonic in room, so that maximum is the worst case (~54 s at
        # 48 kHz for the default max_room_size=1.0)
        return self._tail_for_room(min(ROOM_SIZE.max, self.max_room_size),
                                    ctx.sample_rate)

    def _subblocks(self, ctx: BuildCtx):
        # smallest reachable size (room >= min_room_size; room 0 -> 25):
        # min allpass delay 31*size, min line delay 47*size with <=15
        # samples of vibrato margin.  The min_room_size hint raises both,
        # allowing fewer, larger feedback sub-blocks.
        size_min = self.min_room_size ** 2 * 75.0 + 25.0
        b_ap = ring_ops.pick_subblock(31 * size_min, ctx.block_frames,
                                      cap=2048)
        b_fdn = ring_ops.pick_subblock(47 * size_min - 18, ctx.block_frames,
                                       cap=4096)
        return b_ap, b_fdn

    def process(self, state, x, params, ctx: BuildCtx):
        if ctx.channels != 2:
            raise ValueError("ReverbEffect only supports stereo I/O")
        n = ctx.block_frames
        sr = ctx.sample_rate
        b_ap, b_fdn = self._subblocks(ctx)

        # scheduled Reset: zero the delay lines and filter states at block
        # start (vibrato phases keep their random seeds, like the
        # reference's reset which only flushes buffers)
        rst = params.get("_reset", jnp.float32(0.0)) > 0.5
        state = {
            k: (v if k == "vib_phase" else jax.tree.map(
                lambda a: jnp.where(rst, jnp.zeros_like(a), a)
                if jnp.issubdtype(a.dtype, jnp.floating) else a, v))
            for k, v in state.items()
        }

        room = params[ROOM_SIZE.id]  # [n] linear-smoothed
        if self.max_room_size < 1.0:
            # capacity contract: buffers are sized for max_room_size, so the
            # clamp never binds for in-contract automation
            room = jnp.minimum(room, np.float32(self.max_room_size))
        if self.min_room_size > 0.0:
            # floor contract: sub-blocks are sized for min_room_size (see
            # _subblocks); the clamp never binds for in-contract automation
            room = jnp.maximum(room, np.float32(self.min_room_size))
        wet = params[WET.id]  # [n] exp-smoothed
        # derived controls (reverb.rs:408-420); sizes at block rate
        room0 = room[0]
        size_arr = room * room * 75.0 + 25.0
        size0 = room0 * room0 * 75.0 + 25.0
        cutoff = jnp.clip(10000.0 - room * wet * 3000.0, 20.0, sr / 2.0)
        depth_factor = 1.0 - (1.0 - (0.82 - ((1.0 - room) * 0.7 + size_arr * 0.002))) ** 4
        blend = 0.955 - size_arr * 0.007
        regen = depth_factor * 0.5

        line_delay = (jnp.asarray(_LINE_FACTORS, jnp.float32) * size0).astype(jnp.int32)
        ap_delay = (jnp.asarray(_AP_FACTORS, jnp.float32) * size0).astype(jnp.int32)
        predelay = (jnp.float32(_PRE_FACTOR) * size0).astype(jnp.int32)

        # ---- predelay (write-then-read integer delay) + biquad A + sin -----
        # chronological buffer: [history | this block] — the delayed block is
        # one contiguous slice at start (PRE_MAX - predelay)
        dt_s = ctx.scan_dtype
        pre_big = jnp.concatenate([state["pre"], x.astype(dt_s)], axis=-1)
        delayed_in = jax.lax.dynamic_slice(
            pre_big, (jnp.int32(0), jnp.int32(self._pre_max) - predelay),
            (2, n))
        pre = pre_big[:, n:]

        coefs_a = filters.biquad_coefficients(filters.LOWPASS, sr, cutoff, 1.618034)
        bq_a, filt_a = filters.tpt_process(state["bq_a"], delayed_in, coefs_a, dtype=ctx.scan_dtype)
        drive_in = jnp.sin(filt_a * wet[None, :])

        # ---- 4 cascaded allpasses in ONE sub-block feedback scan -----------
        # Within a sub-block (< min allpass delay), stage a+1's sample j
        # depends only on stage a's sample j and its own >=775-sample-old
        # buffer, so all four stages chain inside one scan step — same math
        # as four separate scans, a quarter of the scan overhead.  Buffers
        # are chronological [4, 2, H + n]: the write is one contiguous
        # dynamic_update_slice at H + t0, the integer-delay read one
        # contiguous dynamic_slice at H + t0 - delay (delay <= 4300 < H).
        # The carry is the ROLLING history window itself ([4, 2, H]), NOT a
        # [4, 2, H + n] absolute-time buffer: carrying the whole-block
        # buffer through dynamic_update_slice made every scan step copy
        # ~4 MB (XLA cannot alias a carry it also slices), which dominated
        # the reverb's block cost.  Reads stay legal because a sub-block is
        # shorter than the smallest reachable delay, so a step never reads
        # its own writes: window index of an absolute delay d is H - d.
        h_ap = self._ap_buf

        def ap_step(buf4, idx):
            t0 = idx * b_ap
            z = jnp.zeros_like(t0)
            sig = jax.lax.dynamic_slice(
                drive_in, (z, t0), (2, b_ap)).astype(dt_s)
            stage_outs = []
            writes = []
            for a in range(4):
                delayed = jax.lax.dynamic_slice(
                    buf4, (jnp.int32(a), z, h_ap - ap_delay[a]),
                    (1, 2, b_ap))[0]
                w = sig - delayed * 0.5
                sig = w * 0.5 + delayed
                writes.append(w)
                stage_outs.append(sig)
            buf4 = jnp.concatenate(
                [buf4[:, :, b_ap:], jnp.stack(writes)], axis=-1)
            return buf4, jnp.stack(stage_outs)  # [4, 2, B]

        new_ap_buf, outs = jax.lax.scan(
            ap_step, state["ap_buf"], jnp.arange(n // b_ap, dtype=jnp.int32)
        )
        stages = jnp.moveaxis(outs, 0, -2).reshape(4, 2, n)
        ap_i, ap_j, ap_k, ap_l = stages[0], stages[1], stages[2], stages[3]

        # FDN line inputs (reverb.rs:275-283): a/h <- allpass L, b/g <- K,
        # c/f <- J, d/e <- I
        line_in = jnp.stack([ap_l, ap_k, ap_j, ap_i, ap_i, ap_j, ap_k, ap_l])  # [8, 2, n]

        # ---- 8-line vibrato FDN: one sub-block scan over all lines ---------
        # Chronological buffers [8, 2, H + n].  The ring-slot read at
        # count+1+floor(offset) (mod period) targets the sample written
        # delay - floor(offset) steps earlier, so in absolute time the read
        # for output sample t is buf[t - delay + floor(offset)] with the
        # fraction interpolating one sample newer.  offset = (sin+1)*7 lies
        # in [0, 14], so each step reads ONE contiguous per-line window of
        # b_fdn + 16 starting at t0 - delay and resolves the vibrato with an
        # exact 15-way shift select (plus shift+1 for the interp partner).
        vib_inc = jnp.asarray(_VIB_DEPTHS * VIB_SPEED, dt_s)  # [8]
        blend_b = blend
        regen_b = regen
        h_ln = self._line_buf
        win = b_fdn + 2 * int(VIB_DEPTH) + 2  # window: B reads + 15 shifts + interp partner

        vib_base = state["vib_phase"]  # vibrato phase at block start

        def fdn_step(carry, idx):
            # rolling-window carry (see ap_step comment): buf holds the
            # last H samples; absolute delay d reads at window index H - d
            buf, fb = carry  # [8, 2, H], [8, 2]
            t0 = idx * b_fdn
            z = jnp.zeros_like(t0)
            j = jnp.arange(b_fdn, dtype=jnp.int32)
            vib = vib_base[:, :, None] + vib_inc[:, None, None] * (
                t0.astype(dt_s) + j[None, None, :].astype(dt_s)
            )  # [8, 2, B] -- absolute phase offset from the block start

            # reads happen after step(): position = count+1, vibrato phase
            # advanced once more (reverb.rs:284-301, 554-586).  The integer
            # shift and fraction come from the small offset alone, exactly
            # as the ring formulation computed them.
            offset = (jnp.sin(vib + vib_inc[:, None, None]) + 1.0) * VIB_DEPTH
            off_floor = jnp.floor(offset)
            w_frac = offset - off_floor
            k_int = off_floor.astype(jnp.int32)  # [8, 2, B] in [0, 14]

            # one contiguous window per line: buf[l, :, H - delay_l ...]
            wins = jnp.concatenate([
                jax.lax.dynamic_slice(
                    buf, (jnp.int32(l), z, h_ln - line_delay[l]),
                    (1, 2, win))
                for l in range(8)
            ])  # [8, 2, win]

            # exact shift-select: v1[j] = wins[j + k], v2[j] = wins[j + k + 1]
            v1 = jnp.zeros((8, 2, b_fdn), dt_s)
            v2 = jnp.zeros((8, 2, b_fdn), dt_s)
            for k in range(2 * int(VIB_DEPTH) + 1):
                sel = k_int == k
                v1 = jnp.where(sel, jax.lax.dynamic_slice_in_dim(wins, k, b_fdn, axis=-1), v1)
                v2 = jnp.where(sel, jax.lax.dynamic_slice_in_dim(wins, k + 1, b_fdn, axis=-1), v2)
            bl = jax.lax.dynamic_slice(blend_b, (t0,), (b_fdn,))[None, None, :]
            interp = (1.0 - bl) * (v1 * (1.0 - w_frac) + v2 * w_frac) + v1 * bl  # [8,2,B]

            # cross-line feedback (Householder 4-groups), 1-sample lag
            rg = jax.lax.dynamic_slice(regen_b, (t0,), (b_fdn,))[None, None, :]
            g1 = jnp.sum(interp[:4], axis=0, keepdims=True)
            g2 = jnp.sum(interp[4:], axis=0, keepdims=True)
            gsum = jnp.concatenate([jnp.broadcast_to(g1, (4,) + g1.shape[1:]),
                                    jnp.broadcast_to(g2, (4,) + g2.shape[1:])])
            fb_now = (2.0 * interp - gsum) * rg  # [8, 2, B]
            fb_prev = jnp.concatenate([fb[:, :, None], fb_now[:, :, :-1]], axis=-1)

            x_j = jax.lax.dynamic_slice(line_in, (z, z, t0), (8, 2, b_fdn))
            writes = (x_j + fb_prev).astype(dt_s)
            buf = jnp.concatenate([buf[:, :, b_fdn:], writes], axis=-1)

            out = jnp.mean(interp, axis=0)  # [2, B]
            return (buf, fb_now[:, :, -1]), out

        (line_buf, fb), outs = jax.lax.scan(
            fdn_step, (state["line_buf"], state["fb"]),
            jnp.arange(n // b_fdn, dtype=jnp.int32)
        )
        wet_sig = jnp.moveaxis(outs, 0, 1).reshape(2, n)
        # vibrato phase advances by inc per sample across the whole block;
        # wrap to [0, 2pi) so the accumulator never outgrows float32
        # resolution (unwrapped, the ~3e-4 per-sample increment drops below
        # the representable step after about an hour of playback)
        vib_phase = jnp.mod(
            state["vib_phase"]
            + jnp.asarray(_VIB_DEPTHS * VIB_SPEED, dt_s)[:, None] * n,
            jnp.asarray(2.0 * math.pi, dt_s),
        )

        # ---- output chain: biquad B -> clamp -> asin -> biquad C -> + dry --
        coefs_b = filters.biquad_coefficients(filters.LOWPASS, sr, cutoff, 0.618034)
        bq_b, filt_b = filters.tpt_process(state["bq_b"], wet_sig, coefs_b, dtype=ctx.scan_dtype)
        shaped = jnp.arcsin(jnp.clip(filt_b, -1.0, 1.0))
        coefs_c = filters.biquad_coefficients(filters.LOWPASS, sr, cutoff, 0.5)
        bq_c, filt_c = filters.tpt_process(state["bq_c"], shaped, coefs_c, dtype=ctx.scan_dtype)
        y = (filt_c + x * (1.0 - wet)[None, :]).astype(x.dtype)

        new_state = {
            "pre": pre, "bq_a": bq_a, "bq_b": bq_b, "bq_c": bq_c,
            "ap_buf": new_ap_buf, "line_buf": line_buf,
            "vib_phase": vib_phase, "fb": fb,
        }
        return new_state, y
