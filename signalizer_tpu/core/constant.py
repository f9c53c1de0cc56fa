"""SpectrumConstant — the immutable per-reconfiguration data bundle.

Re-design of the reference's ``TransformConstant``
(ref: Source/Spectrum/TransformConstant.h:44-241). The reference recomputes
this on its render thread whenever a parameter flag fires; here it is a
frozen pytree whose *static* fields (shapes, enums) form the jit cache key
and whose array fields (window kernel, frequency map, gather plans) are
device leaves. Rebuilding a constant therefore costs at most one XLA
recompile when a static field changes, and nothing when only array contents
change (e.g. dB range drag).

The key transformation for the accelerator: the reference's data-*independent* but
branchy per-pixel mapping loop (``mapToLinearSpace``,
ref: Source/Spectrum/TransformDSP.inl:504-1135 — interpolate bins when the
pixel bandwidth is below the FFT resolution, else take the max-magnitude bin
of the pixel's bin chunk) is hoisted to the host as a **remap plan**:
precomputed gather indices + weights for the interpolation region and
segment ids for the bin-max region. On device the whole mapping collapses
to one weighted gather plus one segment-max — dense, static-shaped, fusable.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from signalizer_tpu.core.config import (
    BinInterpolation,
    SpectrumChannels,
    TransformAlgorithm,
    DisplayMode,
    ViewScaling,
    next_pow2,
)
from signalizer_tpu.core.scaling import peak_decay_pole
from signalizer_tpu.core.windows import WindowType, generate_window

# remap routing env is snapshotted ONCE at import (process-start-only
# semantics): flipping it mid-process does nothing — rebuild the Constant
# with an explicit remap_mode to re-route. Kernels read the Constant's
# static fields, never the env.
_ENV_REMAP = os.environ.get("SIGNALIZER_TPU_REMAP", "").lower()

# ref: SpectrumParameters.h:48-51 — LineMain + LineSecond.
NUM_LINE_GRAPHS = 2
# ref: SpectrumParameters.h:78-80.
MIN_DBS = -24.0 * 16
MAX_DBS = 24.0 * 4
LANCZOS_FILTER_SIZE = 5  # ref: TransformDSP.inl:514


@dataclasses.dataclass(frozen=True)
class RemapPlan:
    """Precomputed pixel<-bin mapping (host numpy; becomes device arrays).

    ``n_values`` spectrum values feed ``axis_points`` display pixels.
    Pixels ``[0, interp_break)`` use tap interpolation; the rest use
    chunked bin-max (ref: TransformDSP.inl:567-639 loop structure).
    """

    # [P, taps] gather indices into the spectrum value array, reflected at
    # the edges (|X| is even-symmetric around DC/Nyquist for real inputs).
    interp_indices: np.ndarray
    # [P, taps] interpolation weights (None: one-hot; Linear: 2 taps;
    # Lanczos: 2*a taps).
    interp_weights: np.ndarray
    # [P] True where the pixel uses interpolation, False where bin-max.
    interp_mask: np.ndarray
    # [n_values] bin -> pixel id for multi-bin chunks (== P for bins not
    # owned by any pixel). Chunks {oldBin+1 .. bin} are disjoint.
    segment_ids: np.ndarray
    # [P] the single bin sampled when a bin-max pixel's chunk is empty
    # (diff == 0 case in the reference loop).
    single_bin: np.ndarray
    # [P] True where the bin-max pixel has an empty chunk.
    single_mask: np.ndarray
    # [P, maxband] banded view of the same chunks: each bin-max pixel's
    # chunk {oldBin+1 .. bin} is CONTIGUOUS, so a constant-index gather +
    # masked max can replace the scatter-based segment max (a remap A/B
    # candidate, tools/remap_bench.py). Interp/single pixels
    # get all-masked rows.
    band_idx: np.ndarray
    band_mask: np.ndarray
    n_values: int
    interp_break: int


def _lanczos_kernel(t: np.ndarray, a: int) -> np.ndarray:
    out = np.sinc(t) * np.sinc(t / a)
    return np.where(np.abs(t) < a, out, 0.0)


def _reflect_indices(idx: np.ndarray, n: int) -> np.ndarray:
    """Reflect indices into [0, n-1] (even symmetry at both ends)."""
    period = max(2 * (n - 1), 1)
    idx = np.abs(idx) % period
    return np.where(idx > n - 1, period - idx, idx)


def build_remap_plan(
    mapped_frequencies: np.ndarray,
    sample_rate: float,
    transform_size: int,
    interpolation: BinInterpolation,
    *,
    full_circle: bool = False,
) -> RemapPlan:
    """Replicates the reference's interpolate-vs-binmax pixel walk
    (ref: TransformDSP.inl:562-639) as static gather/segment tables.

    ``full_circle=True`` is the Complex channel mode, where pixels map the
    whole 0..fs circle of an N-point complex FFT; otherwise values are the
    ``N/2 + 1`` bins of a real FFT.
    """
    P = len(mapped_frequencies)
    N = transform_size
    num_bins = N // 2
    top_frequency = sample_rate / 2.0
    freq_to_bin = num_bins / top_frequency
    n_values = N if full_circle else num_bins + 1
    # Complex (full-circle) mode switches to bin-max at TWICE the pixel
    # density: fftBandwidth = 1/(numBins*2) (ref: TransformDSP.inl:995,
    # vs 1/numBins in the half-spectrum paths :562/875)
    fft_bandwidth = 1.0 / (num_bins * 2) if full_circle else 1.0 / num_bins

    f = np.asarray(mapped_frequencies, dtype=np.float64)

    # --- find the interpolation break point --------------------------------
    # for x in [0, P-1): interpolate while pixel bandwidth <= fft bandwidth.
    # The final pixel always falls through to the bin-max loop
    # (ref loop bound `x < axisPoints - 1`, TransformDSP.inl:568).
    bw = np.empty(P, dtype=np.float64)
    bw[: P - 1] = (f[1:] - f[:-1]) / top_frequency
    bw[P - 1] = np.inf
    over = np.nonzero(bw > fft_bandwidth)[0]
    interp_break = int(over[0]) if len(over) else P - 1

    # --- interpolation taps -------------------------------------------------
    pos = f * freq_to_bin  # fractional bin position per pixel
    if interpolation == BinInterpolation.NONE:
        # +0.5 centering, clamped (ref: TransformDSP.inl:577)
        taps = 1
        idx = np.clip((pos + 0.5).astype(np.int64), 0, n_values - 1)[:, None]
        wts = np.ones((P, 1), dtype=np.float64)
    elif interpolation == BinInterpolation.LINEAR:
        taps = 2
        i0 = np.floor(pos).astype(np.int64)
        frac = pos - i0
        idx = np.stack([i0, i0 + 1], axis=1)
        wts = np.stack([1.0 - frac, frac], axis=1)
    elif interpolation == BinInterpolation.LANCZOS:
        a = LANCZOS_FILTER_SIZE
        taps = 2 * a
        i0 = np.floor(pos).astype(np.int64)
        offs = np.arange(-a + 1, a + 1)
        idx = i0[:, None] + offs[None, :]
        wts = _lanczos_kernel(pos[:, None] - idx, a)
    else:  # pragma: no cover
        raise ValueError(interpolation)

    if full_circle:
        idx = idx % n_values
    else:
        idx = _reflect_indices(idx, n_values)

    interp_mask = np.zeros(P, dtype=bool)
    interp_mask[:interp_break] = True

    # --- bin-max chunks ------------------------------------------------------
    segment_ids = np.full(n_values, P, dtype=np.int64)
    single_bin = np.zeros(P, dtype=np.int64)
    single_mask = np.zeros(P, dtype=bool)

    band_lo = np.zeros(P, dtype=np.int64)
    band_len = np.zeros(P, dtype=np.int64)

    old_bin = int(pos[interp_break])  # truncation, ref :606
    for x in range(interp_break, P):
        b = int(pos[x])
        b = min(b, n_values - 1)
        diff = b - old_bin
        if diff <= 0:
            single_bin[x] = b
            single_mask[x] = True
        else:
            lo = min(old_bin + 1, n_values - 1)
            hi = min(b, n_values - 1)
            segment_ids[lo : hi + 1] = x
            band_lo[x] = lo
            band_len[x] = hi - lo + 1
        old_bin = b

    maxband = max(int(band_len.max()), 1)
    j = np.arange(maxband)[None, :]
    band_idx = np.clip(band_lo[:, None] + j, 0, n_values - 1)
    band_mask = j < band_len[:, None]

    return RemapPlan(
        interp_indices=idx.astype(np.int32),
        interp_weights=wts,
        interp_mask=interp_mask,
        segment_ids=segment_ids.astype(np.int32),
        single_bin=single_bin.astype(np.int32),
        single_mask=single_mask,
        band_idx=band_idx.astype(np.int32),
        band_mask=band_mask,
        n_values=n_values,
        interp_break=interp_break,
    )


def dense_interp_matrix(plan: RemapPlan) -> np.ndarray:
    """[n_values, P] dense interpolation matrix from the gather plan
    (zero columns for bin-max pixels): the tap interpolation as one dense
    matmul — the other remap A/B candidate (tools/remap_bench.py)."""
    p, taps = plan.interp_indices.shape
    w = np.zeros((plan.n_values, p), np.float32)
    cols = np.broadcast_to(np.arange(p)[:, None], (p, taps))
    keep = np.broadcast_to(plan.interp_mask[:, None], (p, taps))
    np.add.at(
        w,
        (plan.interp_indices[keep], cols[keep]),
        plan.interp_weights[keep].astype(np.float32),
    )
    return w


def remap_frequencies(
    axis_points: int,
    sample_rate: float,
    scaling: ViewScaling,
    *,
    view_left: float = 0.0,
    view_right: float = 1.0,
    min_freq: float = 10.0,
    configuration: SpectrumChannels = SpectrumChannels.LEFT,
) -> np.ndarray:
    """Pixel -> frequency map (ref: TransformConstant.h:125-180).

    Linear: evenly spaced across the (zoomed) view; Complex mode doubles the
    span to cover 0..fs. Logarithmic: exponential from ``min_freq`` to
    Nyquist; Complex mode mirrors the log curve around Nyquist.
    """
    view_size = view_right - view_left
    half_rate = sample_rate * 0.5
    i = np.arange(axis_points, dtype=np.float64)

    if scaling == ViewScaling.LINEAR:
        complex_factor = 2.0 if configuration == SpectrumChannels.COMPLEX else 1.0
        freq_per_pixel = half_rate / (axis_points - 1)
        return complex_factor * (view_left * half_rate + view_size * i * freq_per_pixel)

    # logarithmic
    end = half_rate
    arg = view_left + view_size * i / (axis_points - 1)
    if configuration != SpectrumChannels.COMPLEX:
        return min_freq * np.power(end / min_freq, arg)
    lower = min_freq * np.power(end / min_freq, arg * 2.0)
    upper = end + (end - min_freq * np.power(end / min_freq, 1.0 - (arg - 0.5) * 2.0))
    return np.where(arg < 0.5, lower, upper)


@dataclasses.dataclass(frozen=True)
class HostMirror:
    """Hashable host-side mirror of design-time constant fields.

    Rides a Constant as STATIC aux data so it survives every pytree
    flatten/unflatten — ``dataclasses.replace``, ``tree_map``, jit
    reconstruction, checkpoint restore — unlike a stapled-on attribute,
    which silently vanishes. Host consumers (render feeds, trackers, the
    resonator builder) read the design-time values from here instead of
    waiting on a device readback. Bytes-backed so
    static-field hashing/equality for the jit cache key is well defined;
    the hash is computed once and cached (the mirror can hold ~100 KB of
    plan tables — hashing that per dispatch would tax sub-ms ticks).

    The mirror holds DESIGN-TIME values: if a caller retunes a mirrored
    array leaf via ``dataclasses.replace`` without rebuilding the
    constant, the mirror keeps the design-time copy (stale by intent —
    rebuild via the ``make_*_constant`` factory to refresh it).
    """

    names: tuple
    blobs: tuple
    shapes: tuple
    dtypes: tuple

    @classmethod
    def of(cls, **arrays) -> "HostMirror":
        names, blobs, shapes, dtypes = [], [], [], []
        for name in sorted(arrays):
            arr = np.ascontiguousarray(np.asarray(arrays[name]))
            names.append(name)
            blobs.append(arr.tobytes())
            shapes.append(arr.shape)
            dtypes.append(str(arr.dtype))
        return cls(tuple(names), tuple(blobs), tuple(shapes), tuple(dtypes))

    def __contains__(self, name: str) -> bool:
        return name in self.names

    def get(self, name: str):
        i = self.names.index(name)
        arr = np.frombuffer(self.blobs[i], self.dtypes[i]).reshape(self.shapes[i])
        # writable copy; scalars come back as python scalars (the legacy
        # dict mirror stored inv_size/low_dbs/high_dbs as floats)
        return arr[()] if arr.ndim == 0 else np.array(arr)

    def __hash__(self):
        h = self.__dict__.get("_hash")
        if h is None:
            h = hash((self.names, self.blobs, self.shapes, self.dtypes))
            object.__setattr__(self, "_hash", h)
        return h


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SpectrumConstant:
    """Immutable spectrum configuration pytree.

    Static fields (jit-key; metadata) mirror the reference's enum state;
    array fields are device leaves. Built via :func:`make_spectrum_constant`.
    """

    # --- static -------------------------------------------------------------
    axis_points: int = dataclasses.field(metadata=dict(static=True))
    window_size: int = dataclasses.field(metadata=dict(static=True))
    transform_size: int = dataclasses.field(metadata=dict(static=True))
    configuration: SpectrumChannels = dataclasses.field(metadata=dict(static=True))
    bin_interpolation: BinInterpolation = dataclasses.field(metadata=dict(static=True))
    view_scaling: ViewScaling = dataclasses.field(metadata=dict(static=True))
    algo: TransformAlgorithm = dataclasses.field(metadata=dict(static=True))
    display_mode: DisplayMode = dataclasses.field(metadata=dict(static=True))
    sample_rate: float = dataclasses.field(metadata=dict(static=True))
    num_line_graphs: int = dataclasses.field(metadata=dict(static=True))
    interp_taps: int = dataclasses.field(metadata=dict(static=True))
    n_spectrum_values: int = dataclasses.field(metadata=dict(static=True))

    # --- array leaves ---------------------------------------------------------
    window_kernel: jax.Array  # [window_size] f32
    inv_size: jax.Array  # scalar f32: windowKernelScale/(windowSize*0.5)
    mapped_frequencies: jax.Array  # [P] f32
    slope_map: jax.Array  # [P] f32 — b * f^a power slope
    low_dbs: jax.Array  # scalar f32
    high_dbs: jax.Array  # scalar f32
    clip_db: jax.Array  # scalar f32
    decay_poles: jax.Array  # [num_line_graphs] f32 per-frame decay
    # remap plan leaves
    interp_indices: jax.Array  # [P, taps] i32
    interp_weights: jax.Array  # [P, taps] f32
    interp_mask: jax.Array  # [P] bool
    segment_ids: jax.Array  # [n_values] i32
    single_bin: jax.Array  # [P] i32
    single_mask: jax.Array  # [P] bool
    band_idx: jax.Array  # [P, maxband] i32 — contiguous bin-max chunks
    band_mask: jax.Array  # [P, maxband] bool
    # [n_values, P] f32 dense interp matrix, built ONLY when the matmul
    # remap candidate is requested (remap_mode=matmul|both): it is
    # nv*P*4 bytes (33 MB at a 16384-pt window), too heavy to carry by
    # default.
    interp_dense: Optional[jax.Array] = None

    # --- static routing (jit key; resolved ONCE at construction) ----------
    # Which display-remap formulation the spectrum kernels use ("gather"
    # scatter segment-max, the default, or the "banded"/"matmul"/"both"
    # candidates — float-equivalent, see kernels/spectrum._remap). Carried
    # as a static field so the routing rides the jit cache key instead of
    # ambient env reads at trace time.
    remap_mode: str = dataclasses.field(
        default="gather", metadata=dict(static=True)
    )
    # host-side mirror of the design-time plan (STATIC aux data so it
    # survives pytree round-trips — see :class:`HostMirror`); read via
    # :func:`host_view`
    host_data: Optional[HostMirror] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    @property
    def num_bins(self) -> int:
        return self.transform_size // 2

    @property
    def state_channels(self) -> int:
        """Result rows (ref: TransformConstant.h:183-186)."""
        return self.configuration.state_channels


def make_spectrum_constant(
    *,
    axis_points: int,
    window_size: int,
    sample_rate: float = 48_000.0,
    configuration: SpectrumChannels = SpectrumChannels.LEFT,
    bin_interpolation: BinInterpolation = BinInterpolation.LINEAR,
    view_scaling: ViewScaling = ViewScaling.LINEAR,
    algo: TransformAlgorithm = TransformAlgorithm.FFT,
    display_mode: DisplayMode = DisplayMode.LINE_GRAPH,
    window_type: WindowType = WindowType.HANN,
    window_symmetric: bool = True,
    window_alpha: float = 2.5,
    window_beta: float = 8.0,
    view_left: float = 0.0,
    view_right: float = 1.0,
    min_freq: float = 10.0,
    low_dbs: float = -96.0,
    high_dbs: float = 0.0,
    clip_db: float = MIN_DBS,
    slope_a: float = 0.0,
    slope_b: float = 1.0,
    decay_seconds: Tuple[float, ...] = (0.1, 1.0),
    frames_per_second: float = 60.0,
    num_line_graphs: int = NUM_LINE_GRAPHS,
    mapped_frequencies: Optional[np.ndarray] = None,
    dtype=jnp.float32,
    remap_mode: Optional[str] = None,
) -> SpectrumConstant:
    """Build a :class:`SpectrumConstant` (host precompute + device upload).

    Mirrors the reference's reconfiguration cascade
    (ref: Spectrum.cpp:351-616 handleFlagUpdates): window regeneration,
    frequency remap, slope map, decay pole design — all folded into one
    constructor since the result is immutable.
    """
    transform_size = max(32, next_pow2(window_size))  # ref: TransformConstant.h:84

    # resolve the remap routing ONCE at construction (env snapshot taken
    # at import); callers override with the explicit param
    if remap_mode is None:
        remap_mode = _ENV_REMAP if _ENV_REMAP in ("banded", "matmul", "both") else "gather"
    if remap_mode not in ("gather", "banded", "matmul", "both"):
        raise ValueError(f"unknown remap_mode {remap_mode!r}")

    # a zero dB range divides by log(upper/lower) = 0; the reference
    # enforces a small minimum (CHANGELOG 0.4.0 "Graphical issue when the
    # Spectrum has a dB range of zero")
    if high_dbs - low_dbs < 0.1:
        high_dbs = low_dbs + 0.1

    kernel, scale = generate_window(
        window_type,
        window_size,
        symmetric=window_symmetric,
        alpha=window_alpha,
        beta=window_beta,
    )
    # ref: TransformDSP.inl:540 — normalization making a full-scale sine 0 dB.
    inv_size = scale / (window_size * 0.5)

    if mapped_frequencies is None:
        mapped_frequencies = remap_frequencies(
            axis_points,
            sample_rate,
            view_scaling,
            view_left=view_left,
            view_right=view_right,
            min_freq=min_freq,
            configuration=configuration,
        )
    mapped_frequencies = np.asarray(mapped_frequencies, dtype=np.float64)

    plan = build_remap_plan(
        mapped_frequencies,
        sample_rate,
        transform_size,
        bin_interpolation,
        full_circle=(configuration == SpectrumChannels.COMPLEX),
    )

    # ref: TransformConstant.h:109-118 — slopeMap[i] = b * f[i]^a.
    slope_map = slope_b * np.power(np.maximum(mapped_frequencies, 1e-30), slope_a)

    poles = [
        peak_decay_pole(decay_seconds[min(i, len(decay_seconds) - 1)], frames_per_second)
        for i in range(num_line_graphs)
    ]

    constant = SpectrumConstant(
        axis_points=axis_points,
        window_size=window_size,
        transform_size=transform_size,
        configuration=SpectrumChannels(configuration),
        bin_interpolation=BinInterpolation(bin_interpolation),
        view_scaling=ViewScaling(view_scaling),
        algo=TransformAlgorithm(algo),
        display_mode=DisplayMode(display_mode),
        sample_rate=float(sample_rate),
        num_line_graphs=num_line_graphs,
        interp_taps=plan.interp_indices.shape[1],
        n_spectrum_values=plan.n_values,
        window_kernel=jnp.asarray(kernel, dtype=dtype),
        inv_size=jnp.asarray(inv_size, dtype=dtype),
        mapped_frequencies=jnp.asarray(mapped_frequencies, dtype=dtype),
        slope_map=jnp.asarray(slope_map, dtype=dtype),
        low_dbs=jnp.asarray(low_dbs, dtype=dtype),
        high_dbs=jnp.asarray(high_dbs, dtype=dtype),
        clip_db=jnp.asarray(clip_db, dtype=dtype),
        decay_poles=jnp.asarray(poles, dtype=dtype),
        interp_indices=jnp.asarray(plan.interp_indices),
        interp_weights=jnp.asarray(plan.interp_weights, dtype=dtype),
        interp_mask=jnp.asarray(plan.interp_mask),
        segment_ids=jnp.asarray(plan.segment_ids),
        single_bin=jnp.asarray(plan.single_bin),
        single_mask=jnp.asarray(plan.single_mask),
        band_idx=jnp.asarray(plan.band_idx),
        band_mask=jnp.asarray(plan.band_mask),
        # built iff the resolved mode needs it — a matmul-mode constant
        # can never silently miss its matrix (round-3 advisor finding)
        interp_dense=(
            jnp.asarray(dense_interp_matrix(plan), dtype=dtype)
            if remap_mode in ("matmul", "both")
            else None
        ),
        remap_mode=remap_mode,
        # host-side mirror of the plan for host consumers (render feed,
        # tracker, resonator builder), read via :func:`host_view`. Static
        # aux data (HostMirror) so it survives dataclasses.replace /
        # tree_map / jit round-trips.
        host_data=HostMirror.of(
            mapped_frequencies=np.asarray(mapped_frequencies, np.float64),
            window_kernel=np.asarray(kernel, np.float64),
            # stored 0-d so host_view returns python scalars (legacy
            # dict-mirror behaviour: these were float(...) entries)
            inv_size=np.float64(np.ravel(inv_size)[0]),
            low_dbs=np.float64(np.ravel(low_dbs)[0]),
            high_dbs=np.float64(np.ravel(high_dbs)[0]),
            slope_map=np.asarray(slope_map, np.float64),
            interp_indices=plan.interp_indices,
            interp_weights=plan.interp_weights,
            interp_mask=plan.interp_mask,
            segment_ids=plan.segment_ids,
            single_bin=plan.single_bin,
            single_mask=plan.single_mask,
        ),
    )
    return constant


def host_view(constant, name: str):
    """Host copy of a constant field.

    Reads the constant's :class:`HostMirror` static field (survives every
    pytree round-trip), then any legacy stapled ``_host_data`` dict, and
    only then reads the device leaf back with ``jax.device_get``.
    """
    mirror = getattr(constant, "host_data", None)
    if mirror is not None and name in mirror:
        return mirror.get(name)
    data = getattr(constant, "_host_data", None)
    if data is not None and name in data:
        return data[name]
    return jax.device_get(getattr(constant, name))
