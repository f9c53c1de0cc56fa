"""Independent numpy oracle for the spectrum pipeline.

A deliberately *naive*, per-pixel-loop implementation of the reference's
spectrum semantics (ref: Source/Spectrum/TransformDSP.inl mapToLinearSpace
:504-1135 and mapAndTransformDFTFilters :1297-1435), written directly from
the algorithm description so it shares no code with the vectorized device
implementation. Used to validate the gather/segment remap plan, scaling
conventions and dB mapping.

Edge-tap convention: interpolation taps outside [0, num_bins] reflect into
the half spectrum (|X| is even-symmetric for real input) — matching the
framework's documented convention (see kernels/spectrum.py module docs).

Independence boundary (be honest about what this validates): the
break-point walk, +0.5 centering, chunk ownership and edge-tap reflection
here intentionally encode the SAME plan semantics as
core/constant.build_remap_plan — both were written from the reference's
loops, so this oracle proves the vectorized gather/segment EXECUTION and
the per-mode value math, not the plan semantics themselves. The plan
semantics are covered separately: each convention cites its reference
line and deviations are documented in kernels/spectrum.py; the trigger
and meter oracles elsewhere in tests/ are fully independent per-sample
state machines.
"""

from __future__ import annotations

import numpy as np

LANCZOS_A = 5


def lanczos_weight(t: float, a: int = LANCZOS_A) -> float:
    if abs(t) >= a:
        return 0.0
    return float(np.sinc(t) * np.sinc(t / a))


def reflect(i: int, n: int) -> int:
    """Reflect index into [0, n-1]."""
    period = max(2 * (n - 1), 1)
    i = abs(i) % period
    return period - i if i > n - 1 else i


def interp_at(values: np.ndarray, pos: float, mode: str, full_circle: bool = False):
    """Interpolate `values` (real or complex) at fractional index `pos`."""
    n = len(values)

    def fetch(i):
        return values[i % n] if full_circle else values[reflect(i, n)]

    if mode == "none":
        return fetch(int(np.clip(int(pos + 0.5), 0, n - 1)))
    if mode == "linear":
        i0 = int(np.floor(pos))
        frac = pos - i0
        return fetch(i0) * (1 - frac) + fetch(i0 + 1) * frac
    if mode == "lanczos":
        i0 = int(np.floor(pos))
        acc = 0.0
        for k in range(-LANCZOS_A + 1, LANCZOS_A + 1):
            idx = i0 + k
            acc = acc + fetch(idx) * lanczos_weight(pos - idx)
        return acc
    raise ValueError(mode)


def pack_channels(frames: np.ndarray, config: str):
    """frames [C, W] -> list of real rows (or one complex row)."""
    left = frames[0].astype(np.float64)
    right = frames[1].astype(np.float64) if frames.shape[0] > 1 else np.zeros_like(left)
    if config == "left":
        return [left]
    if config == "right":
        return [right]
    if config == "merge":
        return [(left + right) * 0.5]
    if config == "side":
        return [(left - right) * 0.5]
    if config == "midside":
        return [(left + right) * 0.5, (left - right) * 0.5]
    if config in ("separate", "phase"):
        return [left, right]
    if config == "complex":
        return [left + 1j * right]
    raise ValueError(config)


def half_spectrum(row: np.ndarray, window: np.ndarray, n: int) -> np.ndarray:
    """Windowed zero-padded rFFT with DC/Nyquist halved."""
    x = row[: len(window)] * window
    spec = np.fft.rfft(x, n=n)
    spec[0] *= 0.5
    spec[-1] *= 0.5
    return spec


def spectrum_values_oracle(
    frames: np.ndarray,
    *,
    config: str,
    window: np.ndarray,
    window_scale: float,
    mapped_frequencies: np.ndarray,
    sample_rate: float,
    transform_size: int,
    interpolation: str,
) -> np.ndarray:
    """Per-pixel loop implementation. Returns [rows, P] linear values."""
    N = transform_size
    num_bins = N // 2
    top = sample_rate / 2.0
    freq_to_bin = num_bins / top
    # Complex mode switches to bin-max at TWICE the pixel density
    # (ref: fftBandwidth = 1/(numBins*2), TransformDSP.inl:995)
    fft_bw = 1.0 / (num_bins * 2) if config == "complex" else 1.0 / num_bins
    P = len(mapped_frequencies)
    f = np.asarray(mapped_frequencies, dtype=np.float64)
    window_size = len(window)
    inv_size = window_scale / (window_size * 0.5)

    rows = pack_channels(frames, config)

    # interpolation break point: last pixel always falls to bin-max
    break_x = P - 1
    for x in range(P - 1):
        if (f[x + 1] - f[x]) / top > fft_bw:
            break_x = x
            break

    if config == "complex":
        z = rows[0][:window_size] * window
        spec = np.fft.fft(z, n=N)
        mags = np.abs(spec)
        out = np.zeros((1, P))
        for x in range(break_x):
            # reference interpolates MAGNITUDES: every csf cell is abs()'d
            # before the loops (TransformDSP.inl:999-1002)
            out[0, x] = abs(interp_at(mags, f[x] * freq_to_bin, interpolation, full_circle=True))
        old_bin = int(f[break_x] * freq_to_bin)
        for x in range(break_x, P):
            b = min(int(f[x] * freq_to_bin), N - 1)
            chunk = [b] if b <= old_bin else list(range(old_bin + 1, b + 1))
            out[0, x] = max(mags[c] for c in chunk)
            old_bin = b
        return inv_size * out

    specs = [half_spectrum(r, window, N) for r in rows]
    mags = [np.abs(s) for s in specs]

    if config == "phase":
        l, r = specs
        lm, rm = mags
        out = np.zeros((2, P))
        for x in range(break_x):
            pos = f[x] * freq_to_bin
            il = interp_at(l, pos, interpolation)
            ir = interp_at(r, pos, interpolation)
            mid_c = inv_size * (abs(il) + abs(ir))
            cancel = inv_size * abs(il + ir)
            out[0, x] = inv_size * (
                interp_at(lm, pos, interpolation) + interp_at(rm, pos, interpolation)
            )
            out[1, x] = 1.0 - (cancel / mid_c if mid_c > 0 else 0.0)
        old_bin = int(f[break_x] * freq_to_bin)
        for x in range(break_x, P):
            b = min(int(f[x] * freq_to_bin), num_bins)
            chunk = [b] if b <= old_bin else list(range(old_bin + 1, b + 1))
            # first bin of chunk achieving max of max(|L|^2, |R|^2)
            powers = [max(lm[c] ** 2, rm[c] ** 2) for c in chunk]
            best = chunk[int(np.argmax(powers))]
            mid = inv_size * (lm[best] + rm[best])
            interference = inv_size * abs(l[best] + r[best])
            out[0, x] = mid
            out[1, x] = 1.0 - (interference / mid if mid > 0 else 0.0)
            old_bin = b
        return out

    # magnitude rows (mono, separate, midside): csf is abs()'d before the
    # interpolation loops (TransformDSP.inl:557-560, 866-869) — the
    # <complex> filter template is a storage type, the data is magnitudes
    out = np.zeros((len(rows), P))
    for row_i, m in enumerate(mags):
        for x in range(break_x):
            out[row_i, x] = abs(interp_at(m, f[x] * freq_to_bin, interpolation))
        old_bin = int(f[break_x] * freq_to_bin)
        for x in range(break_x, P):
            b = min(int(f[x] * freq_to_bin), num_bins)
            chunk = [b] if b <= old_bin else list(range(old_bin + 1, b + 1))
            out[row_i, x] = max(m[c] for c in chunk)
            old_bin = b
    return inv_size * out


def db_map_oracle(mags, slope_map, low_dbs, high_dbs, clip_db):
    lower = 10.0 ** (low_dbs / 20.0)
    upper = 10.0 ** (high_dbs / 20.0)
    x = slope_map * np.asarray(mags) / lower
    with np.errstate(divide="ignore"):
        return np.where(x > 0, np.log(np.maximum(x, 1e-300)) / np.log(upper / lower), clip_db)


def peak_decay_oracle(state0, xs, pole):
    """Sequential loop version of the decay recurrence."""
    state = np.asarray(state0, dtype=np.float64).copy()
    outs = []
    for x in xs:
        state = np.maximum(pole * state, x)
        outs.append(state.copy())
    return np.stack(outs), state


# ---------------------------------------------------------------------------
# oscilloscope: trigger, display positions, resample, min-max envelope
# ---------------------------------------------------------------------------

OSC_LANCZOS_A = 10  # ref: OscilloscopeParameters.h:47 (kernel size 10)


def zero_crossing_oracle(x, threshold: float) -> np.ndarray:
    """Rising-zero-crossing state machine (ref: ZeroCrossingProcessor,
    StreamPreprocessing.h:315-349): a crossing arms; the armed origin
    fires once a sample from it on exceeds the threshold. x [W] -> bool
    [W] fire marks at the origins."""
    x = np.asarray(x, np.float64)
    fires = np.zeros(len(x), bool)
    armed = False
    origin = 0
    for i in range(1, len(x)):
        if x[i] > 0 and x[i - 1] < 0:
            armed = True
            origin = i
        if armed and x[i] > threshold:
            armed = False
            fires[origin] = True
    return fires


def display_positions(start, step, num_out: int, fused: bool) -> np.ndarray:
    """Pixel p's source position ``start + p * step`` as float32 evaluates
    it: ``fused`` rounds once (a fused multiply-add), otherwise the product
    is rounded before the add. Both are correctly rounded evaluations of
    the same expression; a compiler may emit either. start, step [...]
    -> [..., num_out] float32."""
    start = np.asarray(start, np.float32)[..., None]
    step = np.asarray(step, np.float32)[..., None]
    p = np.arange(num_out, dtype=np.float32)
    if fused:
        return (start.astype(np.float64) + p.astype(np.float64) * step.astype(np.float64)).astype(np.float32)
    return start + p * step


def resample_oracle(x, pos, kind: str = "lanczos", a: int = OSC_LANCZOS_A) -> np.ndarray:
    """Per-tap display resample in float64 (ref: drawWavePlot's sampleAt
    loops, OscilloscopeRendering.cpp:854-888): pixel value = sum over the
    taps around ``pos`` of weight * sample, taps clamped to the frame.
    kind: "lanczos" (2a windowed-sinc taps), "linear" (2 taps) or
    "nearest" (floor(pos + 0.5)). x [..., W], pos [..., P] with batch dims
    broadcasting -> [..., P]."""
    x = np.asarray(x, np.float64)
    pos = np.asarray(pos, np.float64)
    w = x.shape[-1]
    if kind == "nearest":
        taps = np.floor(pos + 0.5)[..., None]
        wts = np.ones_like(taps)
    else:
        half = a if kind == "lanczos" else 1
        taps = np.floor(pos)[..., None] + np.arange(-half + 1, half + 1)
        t = pos[..., None] - taps
        if kind == "lanczos":
            wts = np.where(np.abs(t) < a, np.sinc(t) * np.sinc(t / a), 0.0)
        elif kind == "linear":
            wts = np.maximum(0.0, 1.0 - np.abs(t))
        else:
            raise ValueError(kind)
    g = _take_last(x, np.clip(taps, 0, w - 1).astype(np.int64))
    return np.sum(g * wts, axis=-1)


def minmax_envelope_oracle(x, first, last):
    """Exact min and max of the source samples from the one nearest to
    ``first`` to the one nearest to ``last`` (a pixel's first and last
    sampled positions), clamped to the frame. x [..., W], first/last
    [..., P] with batch dims broadcasting -> (min, max) [..., P]."""
    x = np.asarray(x, np.float64)
    w = x.shape[-1]
    lo = np.clip(np.floor(np.asarray(first, np.float64) + 0.5), 0, w - 1).astype(np.int64)
    hi = np.clip(np.floor(np.asarray(last, np.float64) + 0.5), 0, w - 1).astype(np.int64)
    span = int(np.max(hi - lo)) + 1 if lo.size else 1
    idx = lo[..., None] + np.arange(span)
    inside = idx <= hi[..., None]
    g = _take_last(x, np.minimum(idx, w - 1))
    return np.where(inside, g, np.inf).min(-1), np.where(inside, g, -np.inf).max(-1)


def _take_last(x, idx):
    """x [..., W] at idx [..., P, K] -> [..., P, K]; batch dims broadcast."""
    batch = np.broadcast_shapes(x.shape[:-1], idx.shape[:-2])
    flat = np.broadcast_to(idx.reshape(idx.shape[:-2] + (-1,)), batch + (idx.shape[-2] * idx.shape[-1],))
    g = np.take_along_axis(np.broadcast_to(x, batch + x.shape[-1:]), flat, axis=-1)
    return g.reshape(batch + idx.shape[-2:])
