"""Leaf-type batching: render homogeneous FileSources as one vmapped lane
bank (SURVEY §7.4: "sources batched per leaf-type then summed").

A mixer graph with dozens of file sources otherwise pays per-node dispatch
overhead for each; batching collapses every group of code-path-identical
sources (same loop kind, endlessness, resampling quality, channel layout)
into a single vmapped render over stacked buffers + per-source scalar
arrays, followed by one routing reduction into the owning mixers.

Per-source positions, fades, loop bounds and stop/kill frames become traced
arrays, so the group re-renders without recompiling when any of them change.
The DSP is the exact FileSource math (sources/file.py) — tests assert
bit-equal output against the unbatched path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import resample as rs
from ..ops.convert import panning_factors
from ..ops.precision import ds_add
from ..sources.file import NEVER, FileSource, _host_fade_log1m


def group_key(src: FileSource, ctx):
    if src.loop_range is None:
        loop_kind = "none"
    else:
        loop_kind = src.loop_mode
    return (
        "file",
        src.buffer.channels,
        src.buffer.sample_rate,
        loop_kind,
        src.options.repeat is None,
        src.options.resampling_quality,
        src.options.fade_in_secs > 0.0,
        src.options.fade_out_secs > 0.0,
        # coarse length bucket: every lane zero-pads to the group's longest
        # buffer, so mixing a 3-minute lane with 1-second lanes would
        # multiply memory/FLOPs across the whole group (ops/resample.py)
        rs.length_bucket(src.buffer.frames),
    )


class FileBatch:
    """Static per-group data + the vmapped renderer."""

    def __init__(self, sources: list[FileSource], paths: list[str], ctx):
        self.sources = sources
        self.paths = paths
        self.ctx = ctx
        s0 = sources[0]
        self.loop_kind = "none" if s0.loop_range is None else s0.loop_mode
        self.endless = s0.options.repeat is None
        self.quality = s0.options.resampling_quality
        self.channels_in = s0.buffer.channels
        self.has_fade_in = s0.options.fade_in_secs > 0.0
        self.has_fade_out = s0.options.fade_out_secs > 0.0

        fmax = max(s.buffer.frames for s in sources)
        bufs = np.zeros((len(sources), self.channels_in, fmax + 1), np.float32)
        for i, s in enumerate(sources):
            bufs[i, :, : s.buffer.frames + 1] = np.asarray(s.buffer.data)
        self.buffers = bufs
        self.frames = np.asarray([s.buffer.frames for s in sources], np.int32)
        self.start_time = np.asarray(
            [s.options.start_time for s in sources], np.int32)
        self.repeat = np.asarray(
            [0 if s.options.repeat is None else s.options.repeat for s in sources],
            np.int32)
        self.loop_start = np.asarray(
            [0 if s.loop_range is None else int(s.loop_range[0]) for s in sources],
            np.int32)
        self.loop_end = np.asarray(
            [1 if s.loop_range is None else int(s.loop_range[1]) for s in sources],
            np.int32)
        self.ratio = np.asarray(
            [s.buffer.sample_rate / ctx.sample_rate for s in sources], np.float32)
        sr = ctx.sample_rate
        self.fade_in_log1m = np.asarray(
            [_host_fade_log1m(s.options.fade_in_secs, sr) if s.options.fade_in_secs > 0
             else 0.0 for s in sources], np.float32)
        self.fade_out_log1m = np.asarray(
            [_host_fade_log1m(s.options.fade_out_secs, sr) if s.options.fade_out_secs > 0
             else 0.0 for s in sources], np.float32)
        self.sinc = None
        self.buffers_mm = None
        if self.quality == "high":
            # per-source sinc tables share one (conservative) cutoff
            max_r = max(float(r * s.options.speed) for r, s in zip(self.ratio, sources))
            self.sinc = rs.sinc_table(cutoff=min(1.0, 1.0 / max(max_r, 1.0)))
            self.mode = "sinc"
        elif rs.use_mm2(fmax + 1):
            # one-hot two-stage read (ops/resample.py); its stage-2 cost is
            # independent of buffer length
            self.buffers_mm = rs.mm_pack(bufs)
            self.mode = "mm2"
        else:  # long buffers: the plain gather wins
            self.mode = "gather"

    def init_state(self):
        s = len(self.sources)
        if self.mode == "mm2":
            buf = jnp.asarray(self.buffers_mm)
        else:
            buf = jnp.asarray(self.buffers)
        st = {
            "base": jnp.zeros((s,), jnp.int32),
            "frac": jnp.zeros((s,), jnp.float32),
            "frac_lo": jnp.zeros((s,), jnp.float32),
            "buf": buf,
        }
        # per-lane metadata and the sinc table ride in the state pytree as
        # jit arguments, so they stay out of the compiled program as constants
        st["meta"] = {
            "frames": jnp.asarray(self.frames),
            "repeat": jnp.asarray(self.repeat),
            "loop_start": jnp.asarray(self.loop_start),
            "loop_end": jnp.asarray(self.loop_end),
            "ratio": jnp.asarray(self.ratio),
            "fade_in": jnp.asarray(self.fade_in_log1m),
            "fade_out": jnp.asarray(self.fade_out_log1m),
            "start_time": jnp.asarray(self.start_time),
        }
        if self.sinc is not None:
            st["sinc"] = jnp.asarray(self.sinc)
        return st

    def _fold(self, ki, fr, frames, rpt, lstart, lend):
        """Traced twin of FileSource._fold for this group's static shape."""
        if self.loop_kind != "none":
            length = jnp.maximum(lend - lstart, 1)
            rel = ki - lstart
            if self.loop_kind == "pingpong":
                c = jnp.mod(rel, 2 * length)
                fwd = c < length
                fki = jnp.where(fwd, lstart + c, lstart + 2 * length - c - 1)
                ffr = jnp.where(fwd, fr, 1.0 - fr)
            else:
                fki = lstart + jnp.mod(rel, length)
                ffr = fr
            in_loop = ki >= lstart
            if self.endless:
                return (jnp.where(in_loop, fki, ki), jnp.where(in_loop, ffr, fr),
                        jnp.ones_like(ki, bool))
            span = lstart + (rpt + 1) * length
            after_ki = ki - rpt * length
            fki = jnp.where(ki < span, jnp.where(in_loop, fki, ki), after_ki)
            ffr = jnp.where(ki < span, jnp.where(in_loop, ffr, fr), fr)
            return fki, ffr, ki < frames + rpt * length
        if self.endless:
            return jnp.mod(ki, frames), fr, jnp.ones_like(ki, bool)
        p = jnp.where(rpt > 0, jnp.mod(ki, frames), ki)
        return p, fr, ki < frames * (rpt + 1)

    def _fold_state(self, base, frames, lstart, lend):
        if not self.endless:
            return base
        if self.loop_kind != "none":
            length = jnp.maximum(lend - lstart, 1)
            period = 2 * length if self.loop_kind == "pingpong" else length
            return jnp.where(base >= lstart, lstart + jnp.mod(base - lstart, period), base)
        return jnp.mod(base, frames)

    def render(self, state, frame0, volume, panning, speed, stop_at, kill_at,
               seek_flag, seek_pos):
        """All inputs stacked [S] / [S, n].  Returns (state, out [S, ch, n])."""
        ctx = self.ctx
        n = ctx.block_frames
        sinc_tbl = state.get("sinc")
        meta = state["meta"]
        # static read-window bound for the whole group: max speed ever
        # scheduled on any lane (a growing bucket retraces via the lanes'
        # _spd_tag inputs, see FileSource.lower_block_inputs)
        smax = 2.0 ** max(s._speed_bucket(ctx.sample_rate)
                          for s in self.sources)
        clamp_steps = self.mode == "mm2"

        def lane_pos(base_s, frac_s, lo_s, frames, rpt, lstart, lend, ratio,
                     start_time, spd, kill, sflag, spos):
            gframes = frame0 + jnp.arange(n, dtype=frame0.dtype)
            active = (gframes >= start_time) & (gframes < kill)

            seek_int = jnp.floor(spos)
            base0 = jnp.where(sflag > 0.5, seek_int.astype(jnp.int32), base_s)
            frac0 = jnp.where(sflag > 0.5, spos - seek_int, frac_s)
            lo0 = jnp.where(sflag > 0.5, 0.0, lo_s)

            steps = jnp.where(active, spd * ratio, 0.0).astype(jnp.float32)
            if clamp_steps:
                # guarantees the read-window contract even if a bucket
                # accounting bug ever under-sizes smax (never binds otherwise)
                steps = jnp.minimum(steps, np.float32(smax))
            s0 = steps[-1]
            resid = jnp.cumsum(steps - s0)
            rel = s0 * jnp.arange(n, dtype=jnp.float32) + jnp.concatenate(
                [jnp.zeros((1,), jnp.float32), resid[:-1]])
            p = frac0 + (rel + lo0)
            ip = jnp.floor(p)
            fr = p - ip
            ki = base0 + ip.astype(jnp.int32)

            fki, ffr, live = self._fold(ki, fr, frames, rpt, lstart, lend)
            mask = (active & live).astype(jnp.float32)
            pos = fki.astype(jnp.float32) + ffr

            advance = s0 * np.float32(n) + resid[-1]
            total, lo_new = ds_add(frac0, lo0, advance)
            carry = jnp.floor(total)
            new_base = self._fold_state(base0 + carry.astype(jnp.int32),
                                        frames, lstart, lend)
            return pos, mask, (new_base, total - carry, lo_new)

        pos, mask, (nb, nf, nl) = jax.vmap(lane_pos)(
            state["base"], state["frac"], state["frac_lo"],
            meta["frames"], meta["repeat"], meta["loop_start"],
            meta["loop_end"], meta["ratio"], meta["start_time"],
            speed, kill_at, seek_flag, seek_pos,
        )

        # read step ([S, ch_in, n]), switched per group mode.  Folded
        # positions step by <= smax with mod-fold jumps — the mm2
        # two-band contract (loops/pingpong/wraps exact).
        if self.mode == "sinc":
            audio = jax.vmap(lambda b, p: rs.sinc_read(b, p, sinc_tbl))(
                state["buf"], pos)
        elif self.mode == "mm2":
            audio = jax.vmap(lambda b, p: rs.hermite_read_mm2(
                b, p, smax=smax))(state["buf"], pos)
        else:  # long-buffer group: planar gather
            audio = jax.vmap(rs.hermite_read)(state["buf"], pos)

        def lane_post(audio, mask, fi_log1m, fo_log1m, start_time, vol, pan,
                      stop):
            gframes = frame0 + jnp.arange(n, dtype=frame0.dtype)
            audio = audio * mask[None, :]
            # channel remap (static per group)
            if self.channels_in == 1:
                audio = jnp.concatenate([audio] * min(ctx.channels, 2) +
                                        [jnp.zeros_like(audio)] * max(ctx.channels - 2, 0))
            elif ctx.channels == 1:
                audio = ((audio[0] + audio[1]) * 0.5)[None, :]
            elif self.channels_in != ctx.channels:
                pads = [audio[i] for i in range(min(self.channels_in, 2))]
                pads += [jnp.zeros((n,), audio.dtype)] * (ctx.channels - len(pads))
                audio = jnp.stack(pads[:ctx.channels])

            gain = vol
            k_in = (gframes - start_time + 1).astype(jnp.float32)
            if self.has_fade_in:
                up = 1.0 - jnp.exp(fi_log1m * jnp.maximum(k_in, 0.0))
                gain = gain * jnp.where(k_in > 0,
                                        jnp.where(up > 1.0 - 1e-4, 1.0, up), 0.0)
            k_out = (gframes - stop + 1).astype(jnp.float32)
            if self.has_fade_out:
                down = jnp.exp(fo_log1m * jnp.maximum(k_out, 0.0))
                gain = gain * jnp.where(k_out > 0,
                                        jnp.where(down < 1e-4, 0.0, down), 1.0)
            else:
                gain = gain * (gframes < stop)
            audio = audio * gain[None, :]
            if ctx.channels >= 2:
                left, right = panning_factors(pan)
                audio = audio.at[0].multiply(left).at[1].multiply(right)
            return audio

        out = jax.vmap(lane_post)(
            audio, mask, meta["fade_in"], meta["fade_out"],
            meta["start_time"], volume, panning, stop_at,
        )
        new_state = {"base": nb, "frac": nf, "frac_lo": nl,
                     "buf": state["buf"], "meta": meta}
        if sinc_tbl is not None:
            new_state["sinc"] = sinc_tbl
        return new_state, out


class LeafBatch:
    """Cross-node leaf batching: homogeneous (same ``source_batch_key``)
    Samplers / SynthSources / StreamedFileSources render as ONE vmapped call
    over stacked per-node states + parameter rows, instead of G separate
    renders (SURVEY §7.4).

    Per-lane STATIC config that may differ inside a group (start times,
    synth frequencies, buffer lengths) is declared by the node's
    ``source_batch_statics(ctx)`` and rides in the STATE pytree under
    ``_statics`` — a jit argument, never a closure constant (the same rule
    that keeps FileBatch's metadata in state).  State stacking goes
    through the node class's optional ``batch_pad_states`` hook (the
    Sampler zero-pads buffers to the group's longest, with the live length
    traced as `_buf_frames`).  The DSP is the node's ``process`` verbatim —
    tests assert equality with the unbatched path."""

    def __init__(self, nodes: list, paths: list[str], ctx):
        self.nodes = nodes
        self.paths = paths
        self.ctx = ctx
        self.proto = nodes[0]
        rows = [getattr(n, "source_batch_statics", lambda c: {})(ctx)
                for n in nodes]
        self.statics = {
            k: jnp.asarray([r[k] for r in rows]) for k in (rows[0] or {})
        }

    def init_state(self):
        sts = [s.init_state(self.ctx) for s in self.nodes]
        pad = getattr(type(self.proto), "batch_pad_states", None)
        if pad is not None:
            sts = pad(self.nodes, sts)
        if not jax.tree.leaves(sts[0]):
            st = {}  # stateless lanes (e.g. streamed sources)
        else:
            st = dict(jax.tree.map(lambda *xs: jnp.stack(xs), *sts))
        if self.statics:
            st["_statics"] = dict(self.statics)
        return st

    def render(self, state, pvals):
        """state: stacked pytree (with per-lane statics under ``_statics``);
        pvals: dict of [G, ...] parameter rows.  Returns
        (new_state, out [G, ch, n])."""
        state = dict(state)
        statics = state.pop("_statics", None)
        if statics is not None:
            pvals = {**pvals, **statics}
        fn = lambda st, pv: self.proto.process(st, None, pv, self.ctx)
        axes = (None, 0) if not jax.tree.leaves(state) else (0, 0)
        new, out = jax.vmap(fn, in_axes=axes)(state, pvals)
        if statics is not None:
            if not isinstance(new, dict):  # engine carry assumes dict states
                raise TypeError(
                    f"{type(self.proto).__name__}: source_batch_statics "
                    "requires a dict node state")
            new = dict(new)
            new["_statics"] = statics
        return new, out


SamplerBatch = LeafBatch  # round-3 name, kept for compatibility
