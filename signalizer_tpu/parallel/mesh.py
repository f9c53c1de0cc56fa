"""Multi-device scaling: mesh construction and sharded analysis steps.

The framework's parallelism story (SURVEY.md §2.10/§5.8): the reference's
concurrency is (a) a thread pool over channel pairs and (b) an in-process
multi-instance mix — both map to **data parallelism over the stream/pair
batch axis** here. There is no intrinsic cross-frame dependency except the
peak-decay state, which is per-stream (scan over the time axis, parallel
over streams/pixels), so the scaling layout is:

* mesh axis ``data``: channel pairs / independent streams,
* every Constant leaf replicated,
* per-pair filter states sharded with their frames (state stays resident
  on its chip across steps — no per-step collectives at all),
* diagnostics reductions (global peak, levels) are ``psum``/``pmax``
  collectives inside ``shard_map``.

The mesh is one flat axis over ``jax.devices()``: the layout follows the
algorithm alone, which suits cards that all reach each other at the same
rate (NVLink all to all on a four-GPU host).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from signalizer_tpu.core.constant import SpectrumConstant
from signalizer_tpu.kernels.spectrum import (
    LineGraphState,
    analyze_frames,
    init_line_graph_state,
)


def make_analysis_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    """1-D device mesh over the batch axis.

    Fails fast when fewer than ``n_devices`` devices exist — silently
    truncating would build a smaller mesh and defer the failure to a
    shape assert deep inside the first sharded step.
    """
    devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise RuntimeError(
                f"make_analysis_mesh: requested {n_devices} devices but the "
                f"{devices[0].platform} backend has only {len(devices)}. "
                "For CPU testing set jax.config.update('jax_num_cpu_devices', n) "
                "before any jax op (see tests/conftest.py)."
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def shard_batch(tree, mesh: Mesh, axis: str = "data"):
    """Place a pytree with leading batch axes onto the mesh, sharded on
    axis 0, so XLA never inserts resharding collectives on the hot path."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.device_put(tree, sharding)


def sharded_spectrum_step(
    constant: SpectrumConstant, mesh: Mesh, axis: str = "data"
):
    """Build a jitted multi-chip spectrum step.

    Returns ``step(state, frames, valid) -> (results, new_state,
    global_peak)`` where frames [pairs, T, C, W] and state are sharded over
    ``axis`` on their leading dimension and pairs %% n_devices == 0.
    ``valid`` [T] bool (replicated) masks host-padded frames out of the
    filter states — a backpressure pipeline that zero-pads a short batch
    must not decay its peak state on fabricated silence (review finding).
    """
    spec_b = P(axis)

    def shard_fn(state: LineGraphState, frames: jax.Array, valid: jax.Array):
        result = analyze_frames(constant, state, frames, valid=valid)
        local_peak = jnp.max(result.results)
        peak = jax.lax.pmax(local_peak, axis)
        return result.results, result.state, peak

    mapped = _shard_map(
        shard_fn,
        mesh,
        in_specs=(
            LineGraphState(magnitude=spec_b, phase=spec_b),
            spec_b,
            P(),
        ),
        out_specs=(spec_b, LineGraphState(magnitude=spec_b, phase=spec_b), P()),
    )
    return jax.jit(mapped, donate_argnums=(0,))


def global_peak_level(results: jax.Array) -> jax.Array:
    """Cross-shard diagnostic reduction (works on sharded arrays under jit:
    XLA inserts the all-reduce)."""
    return jnp.max(results)


def sharded_mix_step(mesh: Mesh, axis: str = "data", max_channels: int = 16):
    """The multi-instance mix gather as a mesh collective
    (ref: MixGraphListener::deliver's ring-gather into a ChannelMatrix,
    MixGraphListener.cpp:247-334 — SURVEY.md §5.8 identifies it as an
    all-gather with clock synchronization; clock alignment stays on the
    host in stream/mix_graph.py, and at multi-chip scale the gather+sum
    itself becomes this ``psum``).

    Inputs per call (jit-compatible, sources sharded over the mesh):

    * ``sources`` [S, in_ch, T] — time-aligned source blocks (the host
      aligner's output), sharded on S,
    * ``routing`` [S, in_ch, out_ch] — per-edge gain routing matrix
      (DirectedPortPair analogue; out_ch <= ``max_channels``), sharded
      with its sources.

    Returns (mixed [out_ch, T] replicated on every chip, global peak) —
    every chip ends up with the full presentation block, like every
    reference instance seeing the same presentation stream.
    """

    def shard_fn(sources: jax.Array, routing: jax.Array):
        if routing.shape[-1] > max_channels:
            # enforce the documented contract instead of silently mixing
            # into an oversized matrix (review finding: dead parameter)
            raise ValueError(
                f"routing out_ch ({routing.shape[-1]}) exceeds "
                f"max_channels ({max_channels})"
            )
        # local partial mix on this device's sources; HIGHEST keeps the
        # audio sum in f32 (a default-precision product may round to
        # bf16 or TF32)
        partial = jnp.einsum(
            "sct,sco->ot", sources, routing, precision=jax.lax.Precision.HIGHEST
        )
        mixed = jax.lax.psum(partial, axis)
        peak = jax.lax.pmax(jnp.max(jnp.abs(mixed)), axis)
        return mixed, peak

    fn = _shard_map(
        shard_fn,
        mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(), P()),
    )
    return jax.jit(fn)


def _shard_map(fn, mesh, in_specs, out_specs):
    try:
        from jax import shard_map  # jax >= 0.5
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map
    return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs)


def sharded_oscilloscope_step(constant, mesh: Mesh, axis: str = "data",
                              pairs: Optional[int] = None):
    """Multi-chip oscilloscope step, data-parallel over channel pairs
    (the reference parallelizes all views over pairs —
    ref: SpectrumDSP.cpp:83 parallel_for / CHANGELOG 0.4.0).

    Returns ``step(state, history, window, transport, new_samples) ->
    (frame, new_state, global_level)`` with state/history/frame sharded on
    their leading pairs axis (state stays chip-resident across steps) and
    a ``pmax`` level diagnostic across the mesh.

    ``pairs``: total pair count across the mesh; when given, pairs beyond
    the first draw with hue-rotated key colours exactly like the
    single-device processor (ref: CHANGELOG 0.4.0 multi-pair colours).
    Each shard slices its rows out of the replicated rotation table by
    its mesh position — no extra collective.
    """
    from signalizer_tpu.views.oscilloscope import osc_step_impl

    spec_b = P(axis)
    # one canonical rotation-table builder shared with the single-device
    # processor so sharded and local multi-pair colours cannot drift
    from signalizer_tpu.views.oscilloscope import make_pair_key_colours

    key_table = make_pair_key_colours(constant, pairs or 1)

    def shard_fn(state, history, window, transport, new_samples):
        pair_keys = None
        if key_table is not None:
            lp = history.shape[0]
            # dynamic_slice clamps out-of-range starts silently; a pairs
            # argument that disagrees with the sharded history size would
            # hand later shards duplicated tail colours
            if key_table.shape[0] != lp * mesh.devices.size:
                raise ValueError(
                    f"pairs ({key_table.shape[0]}) != per-shard history rows "
                    f"({lp}) x mesh devices ({mesh.devices.size})"
                )
            i = jax.lax.axis_index(axis)
            pair_keys = jax.lax.dynamic_slice(key_table, (i * lp, 0, 0), (lp, 2, 3))
        frame, new_state = osc_step_impl(
            constant, state, history, window, transport, new_samples, pair_keys
        )
        level = jax.lax.pmax(jnp.max(jnp.abs(history)), axis)
        return frame, new_state, level

    mapped = _shard_map(
        shard_fn,
        mesh,
        in_specs=(spec_b, spec_b, P(), P(), P()),
        out_specs=(spec_b, spec_b, P()),
    )
    return jax.jit(mapped, donate_argnums=(0,))


def sharded_vectorscope_step(mesh: Mesh, axis: str = "data", **static_kwargs):
    """Multi-chip vectorscope step (pairs-parallel).

    ``static_kwargs``: mode/autogain/rotation/scale_to_fill, as accepted by
    the single-chip ``_vs_step``. Returns ``step(state, peak_env, frames,
    envelope_pole, stereo_pole, user_gain, peak_coeff, new_samples) ->
    (frame, new_state, new_peak_env, global_level)``. ``new_samples``
    (replicated scalar) limits the meter filters to the window's trailing
    new samples — a rolling-history caller re-reads overlapping windows,
    and the reference's meters see each sample exactly once
    (Vectorscope.cpp:319-342; review finding).
    """
    from signalizer_tpu.views.vectorscope import vs_step_impl

    spec_b = P(axis)
    rotation = static_kwargs.pop("rotation", 0.0)

    def shard_fn(state, peak_env, frames, envelope_pole, stereo_pole,
                 user_gain, peak_coeff, new_samples):
        frame, new_state, new_peak = vs_step_impl(
            state, peak_env, frames, envelope_pole, stereo_pole, user_gain,
            peak_coeff, rotation, new_samples, **static_kwargs,
        )
        level = jax.lax.pmax(jnp.max(jnp.abs(frames)), axis)
        return frame, new_state, new_peak, level

    mapped = _shard_map(
        shard_fn,
        mesh,
        in_specs=(spec_b, spec_b, spec_b, P(), P(), P(), P(), P()),
        out_specs=(spec_b, spec_b, spec_b, P()),
    )
    return jax.jit(mapped, donate_argnums=(0, 1))


def sharded_spectrogram_step(constant: SpectrumConstant, mesh: Mesh, axis: str = "data"):
    """Multi-chip spectrogram step: per-pair colour columns stay sharded;
    the cross-pair blend is the one collective (psum of premultiplied
    colour, the associative ONE_MINUS_SRC_COLOR composite is order-free in
    its additive premultiplied form — the per-chip partials multiply).

    Returns ``step(state, frames, colours, ratios, valid) ->
    (columns [T, P, 4] u8 replicated, new_state sharded)``; ``valid`` [T]
    masks zero-padded frames out of the filter state (padded slots still
    emit columns — consumers index real columns by the same mask).
    """
    from signalizer_tpu.kernels.colormap import gradient_map, quantize_rgba8

    spec_b = P(axis)

    def shard_fn(state: LineGraphState, frames, colours, ratios, valid):
        # linear decay, matching the single-device spectrogram step so the
        # blend parity stays exact (views/spectrogram.py on the routing)
        result = analyze_frames(
            constant, state, frames, valid=valid, decay_domain="linear"
        )
        intensity = result.results[:, :, 0, 0, :]  # [local_pairs, T, P]
        rgb = jax.vmap(lambda inten, cols: gradient_map(inten, cols, ratios))(
            intensity, colours
        )  # [local_pairs, T, P, 3]
        # blend_pairs computes 1 - prod(1 - c) over pairs; the product over
        # all pairs factors into per-chip partial products + one psum-style
        # all-reduce (log-domain sum or direct product via all_gather —
        # prod reduces as exp(psum(log))); use the numerically
        # safe direct form: psum of log1p(-c) with clamping.
        one_minus = jnp.clip(1.0 - rgb, 1e-7, 1.0)
        local_log = jnp.sum(jnp.log(one_minus), axis=0)  # [T, P, 3]
        total_log = jax.lax.psum(local_log, axis)
        blended = 1.0 - jnp.exp(total_log)
        cols = quantize_rgba8(blended)
        return cols, result.state

    mapped = _shard_map(
        shard_fn,
        mesh,
        in_specs=(
            LineGraphState(magnitude=spec_b, phase=spec_b),
            spec_b,
            spec_b,
            P(),
            P(),
        ),
        out_specs=(P(), LineGraphState(magnitude=spec_b, phase=spec_b)),
    )
    return jax.jit(mapped, donate_argnums=(0,))


def sharded_fused_step(
    constant: SpectrumConstant,
    resample_matrix: jax.Array,
    mesh: Mesh,
    axis: str = "data",
    *,
    pixels: int = 1024,
    envelope_pole: float = 0.999,
    stereo_pole: float = 0.99,
):
    """The fused all-views pipeline (bench cfg5) over a device mesh:
    spectrum + waveform resample + min-max envelopes + stereo meters per
    pair shard, with a single cross-chip pmax diagnostic.

    Returns ``step(state, vstate, frames, valid) -> (results, wave,
    mins, maxs, corr, new_state, new_vstate, global_peak)``; ``valid`` [T]
    masks zero-padded frames out of the peak-decay state, and the meter
    update (which consumes the NEWEST frame) holds when that frame is a
    pad (review finding).
    """
    from signalizer_tpu.kernels.oscilloscope import minmax_decimate, sinc_resample_static
    from signalizer_tpu.kernels.vectorscope import correlation, update_meters

    spec_b = P(axis)

    def shard_fn(state: LineGraphState, vstate, frames, valid):
        r = analyze_frames(constant, state, frames, valid=valid)
        corr = correlation(frames)
        wave = sinc_resample_static(frames[..., 0, :], resample_matrix)
        mins, maxs = minmax_decimate(frames[..., 0, :], pixels)
        vupd = update_meters(
            vstate, frames[:, -1], envelope_pole=envelope_pole, stereo_pole=stereo_pole
        )
        vnew = jax.tree_util.tree_map(
            lambda a, b: jnp.where(valid[-1], a, b), vupd, vstate
        )
        peak = jax.lax.pmax(jnp.max(r.results), axis)
        return r.results, wave, mins, maxs, corr, r.state, vnew, peak

    mapped = _shard_map(
        shard_fn,
        mesh,
        in_specs=(
            LineGraphState(magnitude=spec_b, phase=spec_b),
            spec_b,
            spec_b,
            P(),
        ),
        out_specs=(
            spec_b, spec_b, spec_b, spec_b, spec_b,
            LineGraphState(magnitude=spec_b, phase=spec_b),
            spec_b, P(),
        ),
    )
    return jax.jit(mapped, donate_argnums=(0, 1))


def sharded_resonator_step(
    constant: SpectrumConstant,
    resonator,
    plan,
    mesh: Mesh,
    axis: str = "data",
):
    """The RSNT production tick over a device mesh: each chip's pairs
    shard runs mix -> scanned resonate -> windowed readout -> decay+dB
    entirely chip-resident (the bank state [pairs, rows, P, V, 2] never
    leaves its shard), with one pmax diagnostic across the mesh — the same
    pairs-parallel structure as every other view (ref: parallel_for
    over channel pairs, SpectrumDSP.cpp:83; continuous resonate,
    TransformDSP.inl:1163-1211).

    Returns ``step(res_state, graph_state, blocks, valid) -> (results,
    new_res_state, new_graph_state, global_peak)`` with blocks
    [pairs, 2, T, W] pairs-sharded and valid [T] replicated."""
    from signalizer_tpu.views.spectrum import rsnt_chunks_impl

    spec_b = P(axis)

    def shard_fn(res_state, graph_state, blocks, valid):
        results, st, gs = rsnt_chunks_impl(
            constant, resonator, res_state, graph_state, blocks, valid, plan
        )
        peak = jax.lax.pmax(jnp.max(results), axis)
        return results, st, gs, peak

    mapped = _shard_map(
        shard_fn,
        mesh,
        in_specs=(
            spec_b,
            LineGraphState(magnitude=spec_b, phase=spec_b),
            spec_b,
            P(),
        ),
        out_specs=(
            spec_b,
            spec_b,
            LineGraphState(magnitude=spec_b, phase=spec_b),
            P(),
        ),
    )
    return jax.jit(mapped, donate_argnums=(0, 1))


def init_sharded_state(
    constant: SpectrumConstant, pairs: int, mesh: Mesh, axis: str = "data"
) -> LineGraphState:
    state = init_line_graph_state(constant, (pairs,))
    return shard_batch(state, mesh, axis)
