"""Spectrum analysis kernels: window -> FFT -> magnitude -> pixel remap -> dB.

Re-design of the reference's spectrum DSP core
(ref: Source/Spectrum/TransformDSP.inl — prepareTransform :38-231,
doTransform :486-502, mapToLinearSpace :504-1135,
mapAndTransformDFTFilters :1297-1435). Differences by design:

* **Batched.** Every function takes frames ``[..., channels, window]`` and
  processes all leading axes in parallel (the reference's per-channel-pair
  ``parallel_for`` becomes the batch axis; multiple *time*-sequential frames
  use :mod:`signalizer_tpu.kernels.peak_decay`'s associative scan).
* **Clean per-channel real FFTs.** The reference packs two real channels
  into one complex FFT and untangles them afterwards
  (``separateTransformsIPL``) — a CPU-era constant-factor trick that costs
  an awkward mirrored index space. XLA's batched rFFT gives the same
  result directly; we keep the reference's DC/Nyquist half-scaling.
* **Branch-free remap.** The interpolate-vs-binmax pixel walk is replaced
  by the precomputed gather/segment plan in the Constant
  (see :mod:`signalizer_tpu.core.constant`): one weighted gather + one
  segment-max + a static select.

Known tolerated deviations from the reference (all edge-of-display,
sub-0.1 dB): interpolation taps that fall outside the real-FFT half
spectrum gather reflected magnitudes where the reference read raw
mirror-half cells from its full-size array (TransformDSP.inl:591-604),
and
Phase/Separate DC/Nyquist fixups are applied per channel instead of the
reference's overlapping packed-slot updates (TransformDSP.inl:648-652).
Phase-mode smoothing targets ``cancel * mag`` for *every* line graph,
where the reference's ``phase *= mag`` inside the k loop
(TransformDSP.inl:1412) gives graph k the target ``cancel * mag^(k+1)`` —
i.e. secondary graphs' phase displays fade with the magnitude raised to
the graph index, an accumulation quirk we treat as unintended (it makes
LineSecond's cancellation trace vanish for quiet signals) and do not
replicate.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from signalizer_tpu.core.config import SpectrumChannels
from signalizer_tpu.core.constant import SpectrumConstant
from signalizer_tpu.kernels.peak_decay import peak_decay_scan


class LineGraphState(NamedTuple):
    """Per-line-graph peak-decay filter state
    (ref: TransformPair.h:63-94 LineGraphDesc.states)."""

    magnitude: jax.Array  # [..., K, rows, P] decayed peak magnitudes
    phase: jax.Array  # [..., K, P] smoothed phase (Phase mode only)


def init_line_graph_state(
    constant: SpectrumConstant, batch_shape: Tuple[int, ...] = ()
) -> LineGraphState:
    k = constant.num_line_graphs
    rows = constant.state_channels
    p = constant.axis_points
    return LineGraphState(
        magnitude=jnp.zeros(batch_shape + (k, rows, p), dtype=jnp.float32),
        phase=jnp.zeros(batch_shape + (k, p), dtype=jnp.float32),
    )


# ---------------------------------------------------------------------------
# stage 1: channel packing + window (ref: prepareTransform)
# ---------------------------------------------------------------------------


def stitch_preliminary(
    constant: SpectrumConstant,
    history: jax.Array,
    preliminary: jax.Array,
    num_samples: int = None,
) -> jax.Array:
    """Stitch an analysis window from retained history plus a raw
    in-flight block that has NOT been committed to the history yet
    (ref: the preliminary-audio prepareTransform overload,
    TransformDSP.inl:233-484 — the spectrogram's audioEntryPoint frames
    each blob the moment it completes, pulling the newest ``stop =
    min(numSamples, windowSize)`` samples straight from the current
    audio callback's block and the remaining ``windowSize - stop`` from
    the history views, per channel mode).

    ``history`` [..., C, H >= window - stop] (newest last), ``preliminary``
    [..., C, S]; ``num_samples`` (static, defaults to S) = how many leading
    preliminary samples are valid. Returns the stitched [..., C, window]
    frame for :func:`analyze_frames` — windowing/packing then follow the
    committed-history path exactly, so a stitched frame is bit-equal to
    framing after the block commits (locked by tests).

    Deliberate deviation: the reference's ``extraDiscardedSamples`` branch
    (views larger than the window, TransformDSP.inl:246-260) under-fills
    the window's newest slots by the discard count; here the caller hands
    exact-tail history and no discard quirk exists.
    """
    w = constant.window_size
    s = preliminary.shape[-1]
    stop = min(int(num_samples) if num_samples is not None else s, w)
    hist_n = w - stop
    parts = []
    if hist_n:
        h = history.shape[-1]
        if h < hist_n:
            raise ValueError(f"history {h} < required tail {hist_n}")
        parts.append(jax.lax.slice_in_dim(history, h - hist_n, h, axis=-1))
    if stop:
        parts.append(preliminary[..., :stop])
    return jnp.concatenate(parts, axis=-1) if len(parts) > 1 else parts[0]


def _pack_channels(constant: SpectrumConstant, frames: jax.Array) -> jax.Array:
    """frames [..., C, W] -> windowed real rows [..., rows, W] (or complex
    [..., W] for Complex mode). Ref packing factors: TransformDSP.inl:91-215."""
    cfg = constant.configuration
    w = constant.window_kernel
    left = frames[..., 0, :]
    if cfg == SpectrumChannels.LEFT:
        rows = left[..., None, :]
    elif cfg == SpectrumChannels.RIGHT:
        rows = frames[..., 1, :][..., None, :]
    elif cfg == SpectrumChannels.MERGE:
        rows = ((left + frames[..., 1, :]) * 0.5)[..., None, :]
    elif cfg == SpectrumChannels.SIDE:
        rows = ((left - frames[..., 1, :]) * 0.5)[..., None, :]
    elif cfg == SpectrumChannels.MIDSIDE:
        right = frames[..., 1, :]
        rows = jnp.stack([(left + right) * 0.5, (left - right) * 0.5], axis=-2)
    elif cfg in (SpectrumChannels.PHASE, SpectrumChannels.SEPARATE):
        rows = frames[..., :2, :]
    elif cfg == SpectrumChannels.COMPLEX:
        right = frames[..., 1, :]
        return (left * w) + 1j * (right * w)
    else:  # pragma: no cover
        raise ValueError(cfg)
    return rows * w


def _half_spectrum(constant: SpectrumConstant, rows: jax.Array) -> jax.Array:
    """Windowed rows [..., W] -> rFFT bins [..., N/2+1] complex, zero-padded
    to transform_size, with DC and Nyquist halved
    (ref: TransformDSP.inl:551-554 — the one-sided display convention)."""
    n = constant.transform_size
    spec = jnp.fft.rfft(rows, n=n, axis=-1)
    nb = n // 2
    scale = jnp.ones(nb + 1, dtype=rows.dtype).at[0].set(0.5).at[nb].set(0.5)
    return spec * scale


# ---------------------------------------------------------------------------
# stage 2: pixel remap (ref: mapToLinearSpace)
# ---------------------------------------------------------------------------


def _interp(values: jax.Array, constant: SpectrumConstant) -> jax.Array:
    """Weighted tap gather: values [..., n_values] -> [..., P].

    Works on real or complex inputs (f32 weights broadcast; the PHASE
    cancellation pass interpolates complex cells, every other mode
    interpolates magnitudes — the reference abs()'s csf before its
    loops, TransformDSP.inl:557-560/866-869/999-1002)."""
    g = values[..., constant.interp_indices]  # [..., P, taps]
    return (g * constant.interp_weights).sum(-1)


def _segment_reduce(data: jax.Array, constant: SpectrumConstant, op: str) -> jax.Array:
    """Segment max/min over the bin axis: data [..., n_values] -> [..., P].

    Bins not owned by any pixel land in segment P and are dropped. Empty
    segments return the op identity (-inf/+inf) — callers mask them out.
    """
    p = constant.axis_points
    batch_shape = data.shape[:-1]
    flat = data.reshape((-1, data.shape[-1])).T  # [n_values, B]
    # segment_ids are NOT sorted: interpolation-region bins keep the
    # sentinel id P ahead of smaller bin-max pixel ids, so asserting
    # sortedness would be undefined behavior on an accelerator backend.
    fn = jax.ops.segment_max if op == "max" else jax.ops.segment_min
    seg = fn(flat, constant.segment_ids, num_segments=p + 1, indices_are_sorted=False)
    return seg[:p].T.reshape(batch_shape + (p,))


def _remap(constant: SpectrumConstant) -> str:
    """Display-remap routing — a STATIC field of the Constant
    (``remap_mode``, resolved at construction): ``gather`` (default —
    tap gather + scatter segment-max), ``banded`` (constant-index
    contiguous banded gather + masked max), ``matmul`` (tap
    interpolation as one dense matmul), ``both``. The candidates are
    float-equivalent (same taps/chunks, matmul reorders the tap sum);
    ``tools/remap_bench.py`` times them at the headline geometry. On the
    GPU the choice is not measured yet."""
    return constant.remap_mode


def _binmax_mag(mags: jax.Array, constant: SpectrumConstant) -> jax.Array:
    """Chunked bin-max for magnitude rows (ref: TransformDSP.inl:608-639).

    The reference maximizes squared magnitudes then outputs the magnitude at
    the argmax bin — for non-negative magnitudes that equals the plain
    segment max of magnitudes.
    """
    if _remap(constant) in ("banded", "both"):
        # each chunk {oldBin+1..bin} is contiguous: a constant-index
        # banded gather + masked max replaces the scatter
        g = mags[..., constant.band_idx]  # [..., P, maxband]
        segmax = jnp.max(jnp.where(constant.band_mask, g, -jnp.inf), axis=-1)
    else:
        segmax = _segment_reduce(mags, constant, "max")
    single = mags[..., constant.single_bin]
    return jnp.where(constant.single_mask, single, segmax)


def _interp_mag(mags: jax.Array, constant: SpectrumConstant) -> jax.Array:
    """Magnitude interpolation with the |.| rectification applied (the
    Lanczos kernel has negative lobes); routes the tap sum through one
    dense matmul when the matmul candidate is active."""
    if _remap(constant) in ("matmul", "both"):
        if constant.interp_dense is None:
            # only make_spectrum_constant builds the dense matrix;
            # dataclasses.replace(c, remap_mode="matmul") cannot
            raise ValueError(
                "remap_mode is 'matmul'/'both' but interp_dense is missing — "
                "rebuild the constant via make_spectrum_constant(..., "
                "remap_mode=...) instead of dataclasses.replace"
            )
        return jnp.abs(
            jnp.matmul(mags, constant.interp_dense, precision=jax.lax.Precision.HIGHEST)
        )
    return jnp.abs(_interp(mags, constant))


def _remap_mag(mags: jax.Array, constant: SpectrumConstant) -> jax.Array:
    """Interpolate-vs-binmax pixel remap for magnitude rows
    (ref: mapToLinearSpace, TransformDSP.inl:562-639)."""
    return jnp.where(
        constant.interp_mask, _interp_mag(mags, constant), _binmax_mag(mags, constant)
    )


def _binmax_argbin(values: jax.Array, constant: SpectrumConstant) -> jax.Array:
    """First bin index achieving the chunk max of ``values`` per pixel
    (ref: strictly-greater update in TransformDSP.inl:826-838 selects the
    first maximum). values [..., n_values] -> int32 [..., P]."""
    if _remap(constant) in ("banded", "both"):
        # within a mask row band_idx[x, j] = lo + j, and jnp.argmax
        # returns the FIRST maximum — the reference's strictly-greater
        # update semantics
        g = jnp.where(constant.band_mask, values[..., constant.band_idx], -jnp.inf)
        first = constant.band_idx[:, 0] + jnp.argmax(g, axis=-1).astype(jnp.int32)
        return jnp.where(constant.single_mask, constant.single_bin, first)
    nv = constant.n_spectrum_values
    segmax = _segment_reduce(values, constant, "max")
    # scatter the per-pixel max back onto bins; bins not equal to their
    # pixel's max are disqualified
    owner = constant.segment_ids  # [nv]
    p = constant.axis_points
    pixel_max_by_bin = jnp.concatenate(
        [segmax, jnp.full(segmax.shape[:-1] + (1,), jnp.inf, segmax.dtype)], axis=-1
    )[..., owner]
    bin_idx = jnp.arange(nv, dtype=jnp.int32)
    cand = jnp.where(values >= pixel_max_by_bin, bin_idx, nv)
    first = _segment_reduce(cand, constant, "min")
    first = jnp.clip(first, 0, nv - 1).astype(jnp.int32)
    return jnp.where(constant.single_mask, constant.single_bin, first)


def spectrum_values(constant: SpectrumConstant, frames: jax.Array) -> jax.Array:
    """Frames [..., C, W] -> display-space linear values [..., rows, P].

    Output semantics per mode (ref: mapToLinearSpace result layout):

    * mono modes / Complex: rows=1, magnitude.
    * Separate / MidSide: rows=2, (first, second) magnitudes.
    * Phase: rows=2, (mid magnitude, phase-cancellation in [0, 1]).
    """
    cfg = constant.configuration
    inv = constant.inv_size

    if cfg == SpectrumChannels.COMPLEX:
        z = _pack_channels(constant, frames)  # [..., W] complex
        n = constant.transform_size
        spec = jnp.fft.fft(z, n=n, axis=-1)
        mags = jnp.abs(spec)  # [..., N] — full circle, no DC/Nyq halving
        # interpolate MAGNITUDES: the reference abs()'s every csf cell
        # BEFORE its interpolation loops (`csf[i] = std::abs(csf[i])`,
        # TransformDSP.inl:999-1002 — the <complex> filter template is a
        # storage type, the data is real); |.| inside _interp_mag
        # rectifies Lanczos negative lobes
        return (inv * _remap_mag(mags, constant))[..., None, :]

    rows = _pack_channels(constant, frames)  # [..., rows, W]
    spec = _half_spectrum(constant, rows)  # [..., rows, nb+1] complex
    mags = jnp.abs(spec)

    if cfg in (SpectrumChannels.SEPARATE, SpectrumChannels.MIDSIDE):
        # magnitude interpolation: csf is abs()'d before the loops
        # (ref: TransformDSP.inl:866-869)
        return inv * _remap_mag(mags, constant)

    if cfg == SpectrumChannels.PHASE:
        l, r = spec[..., 0, :], spec[..., 1, :]
        # interpolation region: complex interp for cancellation, magnitude
        # interp for mid (ref: TransformDSP.inl:671-803)
        il = _interp(l, constant)
        ir = _interp(r, constant)
        mid_i = inv * (_interp(mags[..., 0, :], constant) + _interp(mags[..., 1, :], constant))
        cancel_num = inv * jnp.abs(il + ir)
        mid_for_cancel = inv * (jnp.abs(il) + jnp.abs(ir))
        cancel_i = 1.0 - jnp.where(mid_for_cancel > 0, cancel_num / jnp.maximum(mid_for_cancel, 1e-30), 0.0)
        # bin-max region: argmax of max(|L|^2, |R|^2) per chunk
        # (ref: TransformDSP.inl:813-850)
        power = jnp.maximum(mags[..., 0, :], mags[..., 1, :])
        maxbin = _binmax_argbin(power, constant)  # [..., P]
        lm = jnp.take_along_axis(l, maxbin.astype(jnp.int32), axis=-1)
        rm = jnp.take_along_axis(r, maxbin.astype(jnp.int32), axis=-1)
        mid_b = inv * (jnp.abs(lm) + jnp.abs(rm))
        interference = inv * jnp.abs(lm + rm)
        cancel_b = 1.0 - jnp.where(mid_b > 0, interference / jnp.maximum(mid_b, 1e-30), 0.0)
        mid = jnp.where(constant.interp_mask, mid_i, mid_b)
        cancel = jnp.where(constant.interp_mask, cancel_i, cancel_b)
        return jnp.stack([mid, cancel], axis=-2)

    # mono modes — rows == 1; magnitude interpolation (csf abs()'d before
    # the loops, ref: TransformDSP.inl:557-560)
    return inv * _remap_mag(mags, constant)


# ---------------------------------------------------------------------------
# stage 3: peak decay + dB mapping (ref: mapAndTransformDFTFilters)
# ---------------------------------------------------------------------------


def _db_map(constant: SpectrumConstant, magnitudes: jax.Array) -> jax.Array:
    """Normalized dB mapping (ref: TransformDSP.inl:1308-1346):
    ``log(slope * mag / lowerFrac) / log(upperFrac / lowerFrac)``, clipped to
    ``clip_db`` where the argument is non-positive. Output is display-space:
    0 at low_dbs, 1 at high_dbs."""
    ln10_over_20 = 0.11512925464970229
    lower = jnp.exp(constant.low_dbs * ln10_over_20)
    upper = jnp.exp(constant.high_dbs * ln10_over_20)
    delta_y_recip = 1.0 / jnp.log(upper / lower)
    x = constant.slope_map * magnitudes / lower
    return jnp.where(x > 0, jnp.log(jnp.maximum(x, 1e-38)) * delta_y_recip, constant.clip_db)


class SpectrumResult(NamedTuple):
    """Post-processed display frames.

    ``results``: [..., T, K, rows, P] normalized display values (rows/K as in
    :class:`LineGraphState`); ``state``: carry for the next call.
    """

    results: jax.Array
    state: LineGraphState


# T (frames per call) at or above which the decay+dB stage runs in log
# domain (see _log_decay_db). Below it — the per-tick session path frames
# T=1-2 — the linear path's boundary-free single step is cheaper than the
# log/exp state round trip. Static shape ⇒ the branch resolves at trace
# time; tests pin both paths to the same oracle.
_LOG_DECAY_MIN_T = 8

_LOG_TINY = -87.49823353377052  # log(1e-38), the _db_map clamp in log space


def _log_decay_db(
    constant: SpectrumConstant,
    mag_state: jax.Array,
    vals: jax.Array,
    poles: jax.Array,
    valid=None,
) -> Tuple[jax.Array, jax.Array]:
    """Peak decay + dB map evaluated in log domain (max-plus algebra).

    Semantics identical (within float rounding) to
    ``_db_map(constant, peak_decay_scan(mag_state, vals[...,None,:,:], poles))``
    — the reference chain TransformDSP.inl:1336-1341 (CPeakFilter) +
    :1308-1346 (dB map). Motivation: the linear-domain associative scan
    carries TWO arrays (running pole product + decayed value, two
    multiplies + max per combine) over the full ``[T, K, rows, P]``
    broadcast, and ``_db_map`` then takes a log per *output* element.
    In log space the recurrence
    ``s[t] = max(pole * s[t-1], x[t])`` becomes the max-plus form
    ``ls[t] = max(lp + ls[t-1], lx[t])``, whose scan solution is a plain
    running max of the tilted sequence ``u[t] = lx[t] - L[t]``
    (``L`` = inclusive prefix sum of per-step ``lp``, identity steps
    contribute 0 for ``valid`` masking):

        ls[t] = L[t] + max(ls0, cummax(u)[t])

    — ONE carried array with a max-only combine, ``log`` evaluated on the
    K-independent ``vals`` (K× fewer transcendentals), and the dB map is
    a pure affine step because it needed ``log(decayed)`` anyway. Zeros
    ride as ``-inf`` (the exact max-plus identity; ``exp(-inf) = 0``
    restores the true linear limit in the carried state).

    Numerics: poles clamp at 1e-20 (a zero pole's one-step decay already
    lands below any representable magnitude, so the clamp is
    display-invisible) which bounds ``|L|`` ≤ 46·T — f32-safe tilt
    magnitudes for any realistic T. Returns ``(results, new_mag_state)``
    with the carried state back in linear domain (``LineGraphState``'s
    public contract is linear magnitudes).
    """
    neg_inf = jnp.float32(-jnp.inf)
    T = vals.shape[-3]
    lx = jnp.where(vals > 0, jnp.log(jnp.where(vals > 0, vals, 1.0)), neg_inf)
    if valid is not None:
        v = jnp.asarray(valid)
        lx = jnp.where(v.reshape((T, 1, 1)), lx, neg_inf)
        lpv = jnp.where(
            v[:, None], jnp.log(jnp.maximum(poles, 1e-20))[None, :], 0.0
        )
    else:
        lpv = jnp.broadcast_to(
            jnp.log(jnp.maximum(poles, 1e-20))[None, :], (T, poles.shape[0])
        )
    L = jnp.cumsum(lpv, axis=0)[:, :, None, None]  # [T, K, 1, 1]
    u = lx[..., :, None, :, :] - L  # [..., T, K, rows, P]
    c = jax.lax.associative_scan(jnp.maximum, u, axis=-4)
    ls0 = jnp.where(
        mag_state > 0, jnp.log(jnp.where(mag_state > 0, mag_state, 1.0)), neg_inf
    )
    ls = L + jnp.maximum(ls0[..., None, :, :, :], c)  # [..., T, K, rows, P]
    # _db_map in log space: log(slope*m/lower)/log(upper/lower) with the
    # exact-identity lower/upper logs (low_dbs * ln(10)/20)
    ln10_over_20 = 0.11512925464970229
    lower_log = constant.low_dbs * ln10_over_20
    upper_log = constant.high_dbs * ln10_over_20
    dyr = 1.0 / (upper_log - lower_log)
    lslope = jnp.where(
        constant.slope_map > 0,
        jnp.log(jnp.maximum(constant.slope_map, 1e-38)),
        neg_inf,
    )
    ld = ls + (lslope - lower_log)
    results = jnp.where(
        ld == neg_inf,
        jnp.float32(constant.clip_db),
        jnp.maximum(ld, _LOG_TINY) * jnp.float32(dyr),
    )
    new_state = jnp.exp(ls[..., -1, :, :, :])
    return results, new_state


def post_process(
    constant: SpectrumConstant,
    state: LineGraphState,
    vals: jax.Array,
    valid=None,
    decay_domain: str = "auto",
) -> SpectrumResult:
    """Apply per-line-graph peak decay + dB mapping over a time-sequence.

    ``vals`` [..., T, rows, P] are *time-ordered* linear display values (from
    :func:`spectrum_values`); the decay recurrence
    ``state = max(pole * state, new)`` (ref: TransformDSP.inl:1336-1341) runs
    as an associative scan over T, parallel over everything else.

    ``valid``: optional [T] bool — False frames are host padding and leave
    every filter state untouched (their result rows are garbage; callers
    slice them off).

    ``decay_domain``: ``"auto"`` (default) runs the stage in log domain for
    T >= ``_LOG_DECAY_MIN_T``. ``"linear"`` forces the linear associative
    scan; the colormap-consuming surfaces (spectrogram family) route here
    explicitly, a choice made on the previous accelerator and not yet
    re-measured on the GPU (see ROADMAP). ``"log"`` forces the log form
    regardless of T.
    """
    poles = constant.decay_poles  # [K]
    # [..., T, K, rows, P]
    seq = vals[..., :, None, :, :]

    if constant.configuration == SpectrumChannels.PHASE:
        mag_seq = seq[..., 0:1, :] * 0.5  # ref: consts::half at :1407
        cancel_seq = seq[..., 1:2, :]
        decayed, new_mag_state = peak_decay_scan(
            state.magnitude[..., 0:1, :], mag_seq, poles[:, None, None],
            time_axis=-4, valid=valid,
        )
        # phase smoothing: one-pole toward (cancel * mag) with pole^0.3
        # (ref: TransformDSP.inl:1395-1419)
        phase_target = cancel_seq[..., 0, :] * mag_seq[..., 0, :]  # [..., T, K, P]
        phase_pole = poles[:, None] ** 0.3

        def smooth_step(carry, xs):
            target, v = xs
            out = jnp.where(v, target + phase_pole * (carry - target), carry)
            return out, out

        # time axis must lead for lax.scan: [..., T, K, P] -> [T, ..., K, P]
        pt = jnp.moveaxis(phase_target, -3, 0)
        v = (
            jnp.asarray(valid)
            if valid is not None
            else jnp.ones(pt.shape[0], bool)
        )
        phase_state, phases = jax.lax.scan(smooth_step, state.phase, (pt, v))
        phases = jnp.moveaxis(phases, 0, -3)  # [..., T, K, P]
        mag_db = _db_map(constant, decayed[..., 0, :])
        phase_db = _db_map(constant, phases)
        results = jnp.stack([mag_db, phase_db], axis=-2)  # [..., T, K, rows=2, P]
        # write the decayed row back into the FULL-shape state: returning a
        # rows=1 slice would change the carried pytree's shape after the
        # first call (recompile per step; scan-carry mismatch)
        full_mag = state.magnitude.at[..., 0:1, :].set(new_mag_state)
        return SpectrumResult(results, LineGraphState(full_mag, phase_state))

    use_log = decay_domain == "log" or (
        decay_domain == "auto" and vals.shape[-3] >= _LOG_DECAY_MIN_T
    )
    if use_log:
        results, new_state = _log_decay_db(
            constant, state.magnitude, vals, poles, valid=valid
        )
        return SpectrumResult(results, LineGraphState(new_state, state.phase))
    decayed, new_state = peak_decay_scan(
        state.magnitude, seq, poles[:, None, None], time_axis=-4, valid=valid
    )
    results = _db_map(constant, decayed)
    return SpectrumResult(results, LineGraphState(new_state, state.phase))


def analyze_frames(
    constant: SpectrumConstant,
    state: LineGraphState,
    frames: jax.Array,
    valid=None,
    decay_domain: str = "auto",
) -> SpectrumResult:
    """Full pipeline: frames [..., T, C, W] -> display results.

    The jittable forward step of the Spectrum view (compose of
    :func:`spectrum_values` + :func:`post_process`); equivalent to the
    reference's per-frame audioEntryPoint -> addAudioFrame chain
    (ref: TransformDSP.inl:1163-1211, :1137-1148). ``valid`` [T] masks
    host-padded frames out of the filter states; ``decay_domain`` routes
    the decay+dB stage (see :func:`post_process` — colormap consumers
    pass ``"linear"``).
    """
    vals = spectrum_values(constant, frames)  # [..., T, rows, P]
    return post_process(constant, state, vals, valid=valid, decay_domain=decay_domain)
