"""Multi-chip scaling: batch independent render lanes over a device mesh.

The reference's only parallelism is an intra-process RT thread pool over
sub-mixers (src/source/mixed/submixer/thread_pool.rs) — there is no
distributed layer to port.  The scaling story here:

  * one device renders one graph (XLA fuses the whole tree, see
    graph/engine.py);
  * `BatchedRenderProgram` batches independent render lanes — copies of a
    graph with different inputs/automation (stems, variations, preview
    renders) — with ``vmap``, and shards the lane axis across a
    ``jax.sharding.Mesh`` so each device renders its own lanes
    (``shard_map``).  Lanes are
    independent, so collectives only appear if a final mixdown across
    lanes is requested (a psum over the lane axis; XLA hands it to NCCL,
    over NVLink between the cards of one host).

How lanes scale on one GPU, and across four, is not measured yet (see
PERF.md, open questions).  The sharded steps are checked against the
unsharded program on four cards by ``chip_smoke.py --four-cards`` and on a
virtual CPU mesh by tests/test_parallel.py and
__graft_entry__.dryrun_multichip.

`BatchedRenderProgram` wraps a compiled RenderProgram: states and block
inputs gain a leading ``lanes`` axis, placed on the mesh's "data" axis.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..graph.engine import RenderProgram


def data_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    devs = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.array(devs), (axis,))


def graph_state_shardings(program: RenderProgram, mesh: Mesh,
                          axis: str = "graph", lane_axis: Optional[str] = None):
    """Sharding pytree for a RenderProgram state that partitions the
    engine's INTERNAL batch axes — file-source lane banks and sibling
    effect-chain lanes — across ``axis`` (the audio analog of tensor
    parallelism: one graph's sources and parallel effect chains split over
    devices, with GSPMD inserting the stem gathers/reductions).
    With ``lane_axis`` set, leaves get a leading independent-lane dimension
    sharded on that axis too (the 2D lanes x graph layout)."""
    lead = (lane_axis,) if lane_axis else ()
    repl = NamedSharding(mesh, P(*lead))
    inner = NamedSharding(mesh, P(*lead, axis))
    n_shards = mesh.shape[axis]

    def tree(template, sh):
        return jax.tree.map(lambda _: sh, template)

    st = program.init_state()
    out = tree(st, repl)
    # a group's lane axis only shards when the mesh divides it evenly;
    # otherwise that group stays replicated (still correct, just not split)
    out["file_batches"] = {
        g: tree(v, inner if len(program.file_batches[g].paths) % n_shards == 0
                else repl)
        for g, v in st["file_batches"].items()}
    out["effect_batches"] = {
        g: [tree(pi, inner if len(program.effect_batches[g]["effects"])
                 % n_shards == 0 else repl) for pi in v]
        for g, v in st["effect_batches"].items()}
    # generator pools (vmapped Sampler/Synth/Streamed lane banks): every
    # leaf is stacked with a leading group-lane axis (LeafBatch.init_state),
    # so the lane axis shards exactly like file_batches when the mesh
    # divides it; otherwise the pool stays replicated (correct, just unsplit)
    out["gen_batches"] = {
        g: tree(v, inner if len(program.gen_batches[g].paths) % n_shards == 0
                else repl)
        for g, v in st.get("gen_batches", {}).items()}
    return out


class GraphShardedProgram:
    """Model-parallel single graph over a device mesh: internal batch axes
    shard via ``graph_state_shardings``; everything else (scalar node
    states, the master effect chain) computes replicated, so the output is
    bit-identical to the unsharded program (validated in
    tests/test_parallel.py).  Best for graphs whose cost is dominated by
    wide source banks / many homogeneous sub-mixer chains.  A custom call
    that GSPMD cannot partition (the follower kernel, in a sharded chain of
    gates or compressors) runs replicated, on lanes gathered onto every
    device."""

    def __init__(self, program: RenderProgram, mesh: Mesh,
                 axis: str = "graph"):
        self.program = program
        self.mesh = mesh
        st_sh = graph_state_shardings(program, mesh, axis)
        self._st_sh = st_sh
        # inputs stay unannotated (host numpy -> replicated); annotating
        # them would require lowering a block at construction, which has
        # host side effects (consumes scheduled resets / feeder windows)
        self.step = jax.jit(program._step, in_shardings=(st_sh, None),
                            out_shardings=(st_sh, NamedSharding(mesh, P())))

    def init_state(self):
        return jax.device_put(self.program.init_state(), self._st_sh)

    def block_inputs(self, block_index: int):
        return self.program.block_inputs(block_index)


class BatchedRenderProgram:
    """vmap + shard a RenderProgram over independent lanes."""

    def __init__(self, program: RenderProgram, lanes: int, mesh: Optional[Mesh] = None,
                 mixdown: bool = False):
        self.program = program
        self.lanes = lanes
        self.mesh = mesh
        self.mixdown = mixdown
        # Under lane-vmap, in-lane effect batching is redundant (the lane
        # axis already amortises every scan) and the nested vmap lowers
        # measurably slower — step through a scalar-effects twin that shares
        # the original program's control state.
        if program.effect_batches:
            import dataclasses
            step_prog = RenderProgram(
                program.root,
                dataclasses.replace(program.config, batch_effects=False))
            step_prog._share_control_from(program)
        else:
            step_prog = program
        self._step_program = step_prog
        # Input trade-off: at few lanes the per-leaf host->device transfers
        # dominate, so inputs ride PACKED (engine.pack_inputs, ~3
        # transfers); at wide lane counts the packed path's per-lane unpack
        # slices can cost more device time than the transfers save, so
        # plain pytree inputs are used above 16 lanes.
        self._packed_inputs = lanes <= 16
        if self._packed_inputs:
            vstep = jax.vmap(
                lambda st, pk: step_prog._step(st, step_prog._unpack_inputs(pk)))
        else:
            vstep = jax.vmap(step_prog._step)

        def step(states, inputs):
            states, audio = vstep(states, inputs)
            if mixdown:
                # cross-lane mixdown: a sum over this device's lanes, then
                # one all-reduce over the devices
                audio = jnp.sum(audio, axis=0, keepdims=True)
                if mesh is not None:
                    audio = jax.lax.psum(audio, "data")
            return states, audio

        self._raw_step = step
        self._scan_jit = None
        if mesh is not None:
            self._lane_sharding = NamedSharding(mesh, P("data"))
            self.step = jax.jit(self._per_device(step, P("data")))
        else:
            self._lane_sharding = None
            self.step = jax.jit(step)

    def _per_device(self, fn, inputs_spec):
        """``fn(states, inputs)`` run by every device on its own lanes.
        Lanes never exchange data, so the program is partitioned by hand
        (``shard_map``) rather than by GSPMD, which would have to replicate
        every custom call it cannot split (the follower kernel), gathering
        all lanes onto every device."""
        return jax.shard_map(
            fn, mesh=self.mesh, in_specs=(P("data"), inputs_spec),
            out_specs=(P("data"), P() if self.mixdown else P("data")),
            check_vma=False)

    def _stack(self, trees):
        return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)

    def init_states(self):
        states = self._stack(
            [self._step_program.init_state() for _ in range(self.lanes)])
        if self._lane_sharding is not None:
            states = jax.device_put(states, self._lane_sharding)
        return states

    def block_inputs(self, block_index: int):
        """Identical automation on every lane (callers can build per-lane
        inputs themselves for divergent automation)."""
        if self._packed_inputs:
            one = self._step_program.packed_block_inputs(block_index)
        else:
            one = self._step_program.block_inputs(block_index)
        tiled = jax.tree.map(
            lambda x: np.ascontiguousarray(
                np.broadcast_to(np.asarray(x), (self.lanes,) + np.shape(x))),
            one)
        if self._lane_sharding is not None:
            tiled = jax.device_put(tiled, self._lane_sharding)
        return tiled

    def render(self, duration_frames: int):
        n = self.program.ctx.block_frames
        num_blocks = max((duration_frames + n - 1) // n, 1)
        states = self.init_states()
        outs = []
        for b in range(num_blocks):
            states, audio = self.step(states, self.block_inputs(b))
            outs.append(audio)
        audio = jnp.concatenate(outs, axis=-1)[..., :duration_frames]
        return np.asarray(audio)

    # -- scan-over-blocks: one dispatch renders many blocks on every lane --

    def stacked_inputs(self, num_blocks: int, start_block: int = 0):
        """[num_blocks, lanes, ...] inputs (identical automation per lane)."""
        per_block = []
        for b in range(start_block, start_block + num_blocks):
            if self._packed_inputs:
                one = self._step_program.packed_block_inputs(b)
            else:
                one = self._step_program.block_inputs(b)
            per_block.append(jax.tree.map(
                lambda x: np.broadcast_to(np.asarray(x),
                                          (self.lanes,) + np.shape(x)), one))
        stacked = jax.tree.map(
            lambda *xs: np.ascontiguousarray(np.stack(xs)), *per_block)
        if self._lane_sharding is not None:
            stacked = jax.device_put(
                stacked, NamedSharding(self.mesh, P(None, "data")))
        return stacked

    @property
    def scan_step(self):
        """jitted ``(states, stacked_inputs) -> (states, audio)`` with audio
        ``[lanes, channels, num_blocks * block_frames]``: a ``lax.scan`` over
        the block axis, so ONE device dispatch renders ``num_blocks`` blocks
        on every lane — the batched analog of
        ``RenderProgram.render(mode="scan")``.  Amortizes per-block dispatch
        and host bookkeeping entirely on-device (offline throughput shape)."""
        if self._scan_jit is None:
            raw = self._raw_step

            def scan_fn(states, stacked):
                states, audios = jax.lax.scan(raw, states, stacked)
                # [blocks, lanes, ch, n] -> [lanes, ch, blocks * n]
                a = jnp.moveaxis(audios, 0, 2)
                states_out = states
                return states_out, a.reshape(a.shape[0], a.shape[1], -1)

            if self._lane_sharding is not None:
                self._scan_jit = jax.jit(
                    self._per_device(scan_fn, P(None, "data")))
            else:
                self._scan_jit = jax.jit(scan_fn)
        return self._scan_jit

    def render_scan(self, duration_frames: int, states=None):
        n = self.program.ctx.block_frames
        num_blocks = max((duration_frames + n - 1) // n, 1)
        states = states if states is not None else self.init_states()
        states, audio = self.scan_step(states, self.stacked_inputs(num_blocks))
        return np.asarray(audio[..., :duration_frames])
