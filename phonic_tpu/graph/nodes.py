"""Render-graph node protocol.

The reference is a pull-model interpreter: `Source::write` / `Effect::process`
virtual calls per block (src/source.rs:80-110, src/effect.rs:86-215).  This
engine inverts this: every node is a *compiler object* — static Python
config plus two pure functions over pytrees — and the graph engine traces all
of them into ONE jitted block-render program (see graph/engine.py).

Node contract:
  * ``PARAMS``: tuple of parameter descriptors (params.py).  The engine owns
    one timeline + on-device smoother per (node, param) and hands ``process``
    a dict of *denormalized, smoothed, per-sample* value arrays [n] — the
    engine-level analog of the reference's SmoothedParameterValue
    (src/parameter/smoothed.rs).
  * ``init_state(ctx)``: returns the node's state pytree (may be {}).
  * ``process(state, x, params, ctx)``: pure; x is planar [channels, n]
    audio (None for sources); returns (new_state, y).

Nodes must be vmap-safe: no Python control flow on traced values.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional

import jax.numpy as jnp

from ..params import Parameter


class BuildCtx(NamedTuple):
    sample_rate: int
    channels: int
    block_frames: int
    max_events: int
    # dtype for recursive filter/feedback state (EngineConfig.scan_dtype):
    # float32 default (validated <= -80..-90 dB vs f64 oracles), float64 for
    # strict-parity renders matching the reference's f64 delay-line state
    scan_dtype: object = jnp.float32


_counter = itertools.count()


class Node:
    PARAMS: tuple[Parameter, ...] = ()
    # relative CPU cost hint 1..10 (reference: src/source.rs:100-103) — kept
    # for API parity / scheduling heuristics in the realtime bridge
    WEIGHT: int = 1

    def __init__(self, name: Optional[str] = None):
        self.name = name or f"{type(self).__name__.lower()}_{next(_counter)}"

    def param(self, pid: str) -> Parameter:
        for p in self.PARAMS:
            if p.id == pid:
                return p
        raise KeyError(f"{self.name}: unknown parameter {pid!r}")

    def param_initials(self) -> dict:
        """Initial raw values per parameter; override to reflect constructor
        options."""
        return {p.id: p.default for p in self.PARAMS}

    def prepare(self, ctx: BuildCtx) -> None:
        """Called once by RenderProgram at construction, before any state
        init or host lowering — receive the build context (sample rate,
        block size) here.  Lowering hooks must never fall back to a default
        rate (a 44.1 kHz program lowering before init would silently
        mis-allocate otherwise)."""
        return None

    def init_state(self, ctx: BuildCtx):
        return {}

    def process(self, state, x, params, ctx: BuildCtx):
        raise NotImplementedError

    # --- non-audio control messages (reference: Effect::process_message) ---
    def handle_message(self, message, time: int = 0) -> None:
        """Host-side message hook (e.g. reverb Reset).  Default: ignore."""
        return None

    # --- node-specific per-block device inputs (e.g. note events) ---------
    def lower_block_inputs(self, block_start: int, block_len: int):
        """Host lowering hook: return a dict of extra per-block arrays that
        ``process`` receives in its params dict (keys should start with
        '_').  Generators use this to deliver voice-allocation tensors."""
        return None


class Effect(Node):
    """Audio in -> audio out.  ``tail_frames`` advertises ring-out length for
    auto-bypass pruning (reference: src/effect.rs:190-215)."""

    def batch_key(self, ctx: BuildCtx):
        """Hashable key for cross-mixer effect batching, or None if this
        effect cannot be vmapped together with others.  Two effects with
        equal keys MUST trace identical programs from ``process`` (the key
        must cover every static attribute ``process`` reads — runtime
        parameters may differ per lane).  The engine batches sibling mixers
        whose effect chains have pairwise-equal key tuples into one vmapped
        chain (the analog of the reference's sub-mixer thread pool,
        src/source/mixed/submixer/thread_pool.rs:278-334)."""
        return None

    def tail_frames(self, ctx: BuildCtx) -> int:
        return 0

    def max_tail_frames(self, ctx: BuildCtx) -> int:
        """Worst-case tail over the full automatable parameter ranges.  The
        auto-bypass limit uses this, not ``tail_frames``: construction-time
        values like feedback/room size can be raised live, and the bypass
        must never engage while a longer runtime tail is still ringing
        (reference keeps a silence counter instead, effect.rs:110-145)."""
        return self.tail_frames(ctx)


class Source(Node):
    """Produces audio; x is None.  ``duration_frames`` returns the total
    frames the source will produce at the *output* rate, or None if unbounded
    (looped / generator) — used for offline render length and compile-time
    activity pruning."""

    def duration_frames(self, ctx: BuildCtx) -> Optional[int]:
        return None
