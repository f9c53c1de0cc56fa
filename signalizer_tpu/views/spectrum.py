"""SpectrumProcessor — the stateful public face of the spectrum view.

Plays the role of the reference's ``Spectrum`` processor + ``TransformPair``
pair (ref: Source/Spectrum/Spectrum.h, SpectrumDSP.cpp:61-227): owns the
Constant, carries the per-pair line-graph filter states across calls, and
exposes a batched jitted step. Rendering (OpenGL in the reference) is out of
scope — outputs are render-ready arrays.

Device shape conventions:
* ``pairs``: the number of channel pairs analyzed in parallel (the
  reference's ``parallel_for`` over pairs, SpectrumDSP.cpp:83) — the batch
  axis.
* ``process(frames)`` with frames ``[pairs, T, 2, window]`` treats T as
  *time-sequential* (decay state threads through) and pairs as parallel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from signalizer_tpu.core.constant import SpectrumConstant, make_spectrum_constant
from signalizer_tpu.kernels.spectrum import (
    LineGraphState,
    SpectrumResult,
    analyze_frames,
    init_line_graph_state,
    post_process,
)


@functools.partial(jax.jit, static_argnums=(), donate_argnums=(1,))
def _step(constant: SpectrumConstant, state: LineGraphState, frames: jax.Array) -> SpectrumResult:
    """Jitted forward step. The decay state is donated: at high frame rates
    this is a pure in-place update on device (no HBM churn)."""
    return analyze_frames(constant, state, frames)


class SpectrumProcessor:
    """Stateful wrapper: constant + carried decay state + jitted step."""

    def __init__(self, constant: SpectrumConstant, pairs: int = 1):
        self.constant = constant
        self.pairs = pairs
        self._state = init_line_graph_state(constant, (pairs,))

    @classmethod
    def create(cls, *, pairs: int = 1, **constant_kwargs) -> "SpectrumProcessor":
        return cls(make_spectrum_constant(**constant_kwargs), pairs=pairs)

    @property
    def state(self) -> LineGraphState:
        """Current decay state. NOTE: ``process`` donates these buffers to
        XLA — a reference held across the next ``process`` call points at
        deleted device memory. Read (``np.asarray``) before processing
        again, or copy with ``jax.tree_util.tree_map(jnp.copy, ...)``."""
        return self._state

    def reset(self) -> None:
        """Clear filter states (ref: resetState semantics)."""
        self._state = init_line_graph_state(self.constant, (self.pairs,))

    def reconfigure(self, constant: SpectrumConstant) -> None:
        """Swap the Constant (ref: handleFlagUpdates rebuild,
        Spectrum.cpp:351-616). Resets state when shapes changed."""
        same_shape = (
            constant.axis_points == self.constant.axis_points
            and constant.state_channels == self.constant.state_channels
            and constant.num_line_graphs == self.constant.num_line_graphs
        )
        self.constant = constant
        if not same_shape:
            self.reset()

    def process(self, frames) -> jax.Array:
        """frames [pairs, T, 2, window] -> display results
        [pairs, T, K, rows, P]; decay state carries across calls."""
        frames = jnp.asarray(frames, dtype=jnp.float32)
        if frames.ndim == 3:  # [pairs, C, W] -> single time step
            frames = frames[:, None]
        result = _step(self.constant, self._state, frames)
        self._state = result.state
        return result.results

    def process_to_host(self, frames) -> np.ndarray:
        return np.asarray(self.process(frames))

    def process_with_preliminary(
        self, history, preliminary, num_samples: int = None
    ) -> jax.Array:
        """Analyze one frame stitched from retained history plus the raw
        in-flight block of the current audio callback — the reference's
        preliminary-audio path (TransformDSP.inl:233-484): display keeps
        up with the newest samples without waiting for the history
        commit. ``history`` [pairs, 2, H] newest-last, ``preliminary``
        [pairs, 2, S]; returns display results [pairs, 1, K, rows, P].
        Bit-equal to committing the block first (tests lock this)."""
        from signalizer_tpu.kernels.spectrum import stitch_preliminary

        history = jnp.asarray(history, jnp.float32)
        preliminary = jnp.asarray(preliminary, jnp.float32)
        frame = stitch_preliminary(self.constant, history, preliminary, num_samples)
        return self.process(frame[:, None])


# ---------------------------------------------------------------------------
# RSNT algorithm path (ref: TransformDSP.inl:1213-1295 resonatingDispatch)
# ---------------------------------------------------------------------------


def _mix_rsnt(cfg, block: jax.Array) -> jax.Array:
    """[pairs, 2, ...] -> [pairs, rows, ...] per resonatingDispatch
    (ref: TransformDSP.inl:1213-1295; the RSNT path does NOT halve
    Mid/Side, unlike prepareTransform)."""
    from signalizer_tpu.core.config import SpectrumChannels

    left, right = block[:, 0], block[:, 1]
    if cfg == SpectrumChannels.LEFT:
        return left[:, None]
    if cfg == SpectrumChannels.RIGHT:
        return right[:, None]
    if cfg == SpectrumChannels.MERGE:
        return (left + right)[:, None]
    if cfg == SpectrumChannels.SIDE:
        return (left - right)[:, None]
    if cfg == SpectrumChannels.MIDSIDE:
        # ref quirk: RSNT MidSide packs (side, mid) in that order
        # (TransformDSP.inl:1277: pair{left - right, left + right})
        return jnp.stack([left - right, left + right], axis=1)
    return block[:, :2]  # PHASE / SEPARATE / COMPLEX


def rsnt_chunks_impl(
    constant: SpectrumConstant,
    resonator,
    res_state: jax.Array,
    graph_state: LineGraphState,
    blocks: jax.Array,
    valid: jax.Array,
    plan,
):
    """ONE dispatch for a whole tick's pending audio: mix -> scanned
    resonate over T chunks -> final windowed readout -> decay+dB.

    blocks [pairs, 2, T, W] time-ordered; valid [T] bool (False = padding,
    state untouched). Returns (results [pairs, 1, K, rows, P], res_state,
    graph_state). Pure/unjitted — shard_map-able over the pairs axis
    (parallel.mesh.sharded_resonator_step)."""
    from signalizer_tpu.core.config import SpectrumChannels
    from signalizer_tpu.kernels.resonator import (
        resonate_chunks,
        resonator_readout,
        resonator_readout_complex,
    )

    mixed = _mix_rsnt(constant.configuration, blocks)  # [pairs, rows, T, W]
    st = resonate_chunks(resonator, res_state, mixed, valid=valid, plan=plan)
    if constant.configuration == SpectrumChannels.PHASE:
        # post_process's PHASE contract is rows = (mid magnitude,
        # cancellation in [0, 1]) — built from the COMPLEX per-channel
        # states exactly like the reference's RSNT Phase branch
        # (mapResonatingSystem, TransformDSP.inl:1111-1127): mid =
        # |L| + |R|, cancellation = 1 - |L + R| / mid. Feeding raw
        # per-channel magnitudes here was a round-3 review find.
        re, im = resonator_readout_complex(resonator, st)  # [pairs, 2, P]
        mag = jnp.sqrt(re * re + im * im)
        mid = mag[:, 0] + mag[:, 1]
        sre, sim = re[:, 0] + re[:, 1], im[:, 0] + im[:, 1]
        interference = jnp.sqrt(sre * sre + sim * sim)
        cancel = 1.0 - jnp.where(
            mid > 0, interference / jnp.maximum(mid, 1e-30), 0.0
        )
        vals = jnp.stack([mid, cancel], axis=1)  # [pairs, 2, P]
    else:
        vals = resonator_readout(resonator, st)  # [pairs, rows, P]
    result = post_process(constant, graph_state, vals[:, None])
    return result.results, st, result.state


_rsnt_chunks_step = jax.jit(rsnt_chunks_impl, donate_argnums=(2, 3))


class ResonatorSpectrumProcessor:
    """Spectrum view driven by the resonator bank instead of the FFT
    (ref: TransformAlgorithm::RSNT). Consumes a *continuous* sample stream
    (no framing); per block: channel-mode mix -> resonate -> windowed
    readout -> peak decay -> dB.

    Channel packing per resonatingDispatch: Mid = L + R and Side = L - R
    (the RSNT path does NOT halve, unlike the FFT path's prepareTransform).
    """

    def __init__(
        self,
        constant: SpectrumConstant,
        *,
        pairs: int = 1,
        window_type=None,
        free_q: bool = False,
    ):
        from signalizer_tpu.core.windows import WindowType
        from signalizer_tpu.kernels.resonator import (
            init_resonator_state,
            make_resonator_constant,
        )

        self.constant = constant
        self.pairs = pairs
        self.rows = constant.state_channels
        from signalizer_tpu.core.constant import host_view

        self.resonator = make_resonator_constant(
            np.asarray(host_view(constant, "mapped_frequencies"), np.float64),
            constant.sample_rate,
            constant.window_size,
            window_type=window_type if window_type is not None else WindowType.HANN,
            free_q=free_q,
        )
        self._res_state = init_resonator_state(self.resonator, (pairs, self.rows))
        self._graph_state = init_line_graph_state(constant, (pairs,))
        self._plans: dict = {}  # chunk length -> ResonatorBlockPlan

    def block_plan(self, block: int):
        """Cached :class:`ResonatorBlockPlan` for ``block``-sample chunks.

        Public so mesh callers (``parallel.mesh.sharded_resonator_step``)
        can feed the sharded RSNT step without reaching into internals.
        """
        from signalizer_tpu.kernels.resonator import make_block_plan

        plan = self._plans.get(block)
        if plan is None:
            plan = self._plans[block] = make_block_plan(self.resonator, block)
        return plan

    # shorthand retained for internal call sites
    _plan = block_plan

    @property
    def res_state(self):
        """Current resonator bank state pytree (read for mesh sharding)."""
        return self._res_state

    @property
    def graph_state(self):
        """Current display decay/graph state pytree (read for mesh sharding)."""
        return self._graph_state

    def reset(self) -> None:
        from signalizer_tpu.kernels.resonator import init_resonator_state

        self._res_state = init_resonator_state(self.resonator, (self.pairs, self.rows))
        self._graph_state = init_line_graph_state(self.constant, (self.pairs,))

    def _mix(self, block: jax.Array) -> jax.Array:
        """[pairs, 2, n] -> [pairs, rows, n] per resonatingDispatch."""
        return _mix_rsnt(self.constant.configuration, block)

    def process(self, block) -> jax.Array:
        """block [pairs, 2, n] -> display results [pairs, 1, K, rows, P].

        One chunk, one dispatch (via :meth:`process_chunks`)."""
        block = jnp.asarray(block, jnp.float32)
        return self.process_chunks(block[:, :, None, :])

    def process_chunks(self, blocks, valid=None) -> jax.Array:
        """Consume a whole tick's pending audio in ONE device dispatch.

        ``blocks`` [pairs, 2, T, W]: T time-ordered chunks of W samples
        each (each sample exactly once — the bank is stateful).
        ``valid`` [T] bool or None: False entries are host-side padding
        (bucketing T to a power of two bounds the compiled shape set);
        they advance nothing. Returns the display results after the last
        valid chunk, [pairs, 1, K, rows, P].

        One scanned dispatch per tick instead of one per chunk (ref:
        continuous resonate, TransformDSP.inl:1163-1211).
        """
        blocks = jnp.asarray(blocks, jnp.float32)
        t = blocks.shape[-2]
        if valid is None:
            valid = np.ones(t, bool)
        valid = jnp.asarray(valid, bool)
        plan = self._plan(blocks.shape[-1])
        results, self._res_state, self._graph_state = _rsnt_chunks_step(
            self.constant,
            self.resonator,
            self._res_state,
            self._graph_state,
            blocks,
            valid,
            plan,
        )
        return results
