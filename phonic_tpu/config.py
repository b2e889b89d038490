"""Engine-wide configuration.

The reference engine (emuell/phonic) processes audio in pull-model blocks of at
most 8192 samples (reference: src/source/mixed.rs:216) and offline-renders in
1024-frame chunks (reference: src/output/wav.rs:25).  Here we instead render
in large fixed-size blocks scanned by the host (or by ``lax.scan`` for fully
offline renders): per-sample control is lowered to analytic parameter ramps so
block size only trades latency against throughput, not correctness.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

# dB value treated as silence / zero gain (reference: src/utils.rs:21).
MINUS_INF_DB = -200.0

# Reference sample rate that smoother coefficients are normalised against
# (reference: src/utils/smoothing.rs:150 `sample_rate_comp = 44100 / sr`).
SMOOTHER_REFERENCE_SR = 44100.0

# Default smoothing inertia for exponential parameter smoothing
# (reference: src/utils/smoothing.rs:135 `DEFAULT_INERTIA = 1/256`).
DEFAULT_INERTIA = 1.0 / 256.0

# Snap threshold: the reference stops ramping once the per-sample increment
# drops below 100 * f32 epsilon (reference: src/utils/smoothing.rs:196-200).
SMOOTHER_EPSILON = 100.0 * float(jnp.finfo(jnp.float32).eps)

# Modulation / glide update granularity in frames
# (reference: src/modulation/processor.rs:14, src/source/file/common.rs:56).
MODULATION_BLOCK = 64


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static configuration for one compiled render program."""

    sample_rate: int = 48000
    channels: int = 2
    # Frames per device render block.  Large blocks amortise dispatch overhead
    # and give the associative scans long parallel runs.
    block_frames: int = 8192
    # Maximum number of scheduled parameter events honoured per block; events
    # beyond this are folded onto the final segment by the host lowering.
    max_events_per_block: int = 16
    # render homogeneous FileSources as vmapped lane banks (graph/batching.py)
    batch_sources: bool = True
    # vmap sibling mixers' identical effect chains into one batched run (the
    # analog of the reference's sub-mixer thread pool; see
    # Effect.batch_key).  Disabled automatically when auto_bypass is on
    # (a lax.cond under vmap runs both branches).
    batch_effects: bool = True
    # emit per-mixer peak/RMS levels from the block step (fused reductions;
    # the reference meters every mixer, src/source/metered.rs)
    meter_mixers: bool = False
    # skip effects whose input has been silent longer than tail + 2 s
    # (reference: EffectProcessor auto-bypass, src/source/mixed/effect.rs).
    # A true lax.cond: leave OFF for vmapped-lane batch rendering, where
    # conditionals execute both branches.
    auto_bypass: bool = False
    # dtype used for audio samples.
    dtype: jnp.dtype = jnp.float32
    # dtype used for recursive filter state / associative scans.  float32 is
    # accurate to below -90 dB for the stock effect suite (validated in
    # tests/test_biquad.py); switch to float64 for strict parity experiments.
    scan_dtype: jnp.dtype = jnp.float32

    @property
    def block_seconds(self) -> float:
        return self.block_frames / float(self.sample_rate)


DEFAULT_CONFIG = EngineConfig()
