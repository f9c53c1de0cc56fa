"""Oscilloscope kernels: triggers, spectral fundamental, resampling.

Re-design of the reference's oscilloscope DSP
(ref: Source/Oscilloscope/OscilloscopeDSP.inl:61-308 spectral trigger,
StreamPreprocessing.h:270-349 peak-hold / zero-crossing processors,
OscilloscopeRendering.cpp:790-891 windowed-sinc pixel resampling).
Differences by design:

* **Zero-crossing detection is vectorized**, not a per-sample state
  machine: the reference arms on a rising crossing and fires the *last*
  crossing origin once a later sample exceeds the threshold — equivalently,
  a crossing fires iff any sample before the next crossing exceeds the
  threshold. That's a cummax-between-crossings computation (segment logic),
  O(log W) depth of elementwise shifts and selects.
* **Peak-hold keeps its sequential scan** (`lax.scan`): its decaying
  envelope carry is genuinely order-dependent.
* **The spectral fundamental search** precomputes the complex quadratic
  bin-offset interpolation for *all* bins vectorized, then runs the
  candidate/hysteresis/harmonic-rejection walk as a `lax.scan` over bins
  with a 3-scalar carry.
* **Sinc resampling** becomes a per-tap gather + on-device Lanczos weight
  evaluation over all output pixels at once (the reference fills a rolling
  21-tap kernel buffer per pixel).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

LOOKAHEAD_SIZE = 8192  # ref: OscilloscopeParameters.h:46
INTERPOLATION_KERNEL_SIZE = 10  # ref: OscilloscopeParameters.h:47
MEDIAN_FILTER_SIZE = 8  # ref: OscilloscopeDSP.inl MedianData::FilterSize
PEAK_DECAY = 0.9999  # ref: StreamPreprocessing.h:291


# ---------------------------------------------------------------------------
# triggers
# ---------------------------------------------------------------------------


def zero_crossing_triggers(x: jax.Array, threshold: float) -> jax.Array:
    """Rising-zero-crossing trigger events (ref: ZeroCrossingProcessor,
    StreamPreprocessing.h:315-349).

    x [..., W] -> bool [..., W]: True at each crossing origin that fires
    (a later sample exceeded ``threshold`` before the next crossing armed).
    Sample 0 can never be a crossing (no predecessor in this frame).
    """
    prev = x[..., :-1]
    cur = x[..., 1:]
    crossing = (cur > 0) & (prev < 0)
    crossing = jnp.concatenate([jnp.zeros_like(x[..., :1], bool), crossing], axis=-1)
    hot = x > threshold
    # a crossing fires iff its segment [origin, next origin) contains a
    # hot sample — a segmented suffix-OR. Computed as a log-depth reset
    # scan over the reversed axis (pure shifts/selects) rather than
    # segment_max + take_along_axis; the formulation was chosen for the
    # previous accelerator and is not re-measured on the GPU yet.
    w = x.shape[-1]
    hr = jnp.flip(hot, -1)
    cr = jnp.flip(crossing, -1)
    # propagation into rev-slot r (from r-1, i.e. original sample i+1) is
    # blocked when sample i+1 starts a new segment
    block_in = jnp.concatenate([jnp.ones_like(cr[..., :1]), cr[..., :-1]], axis=-1)
    v = hr
    blocked = block_in
    d = 1
    while d < w:
        v_prev = jnp.concatenate([jnp.zeros_like(v[..., :d]), v[..., :-d]], axis=-1)
        b_prev = jnp.concatenate(
            [jnp.ones_like(blocked[..., :d]), blocked[..., :-d]], axis=-1
        )
        v = jnp.where(blocked, v, v | v_prev)
        blocked = blocked | b_prev
        d *= 2
    fired = jnp.flip(v, -1)
    return crossing & fired


def last_zero_crossing_trigger(x: jax.Array, threshold: float) -> Tuple[jax.Array, jax.Array]:
    """Index of the most recent firing crossing in the frame, and whether
    one exists. x [..., W] -> (int32 [...], bool [...])."""
    fires = zero_crossing_triggers(x, threshold)
    w = x.shape[-1]
    idx = jnp.arange(w, dtype=jnp.int32)
    last = jnp.max(jnp.where(fires, idx, -1), axis=-1)
    return jnp.maximum(last, 0), last >= 0


def peak_hold_triggers(
    x: jax.Array,
    threshold: float,
    hysteresis: float,
    state: jax.Array = None,
    holding: jax.Array = None,
    decay: float = PEAK_DECAY,
    valid: jax.Array = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Envelope-hold trigger events (ref: PeakHoldProcessor,
    StreamPreprocessing.h:270-312).

    Squared-sample peak tracker: while rising, arm when the jump exceeds
    ``hysteresis * state``; on the first fall, fire the previous sample and
    decay the held state by 0.9999 (floored at threshold^2). Genuinely
    sequential -> lax.scan over samples.

    ``valid`` [W] (or broadcastable) marks which samples to CONSUME;
    invalid slots are identity steps (state unchanged, no fire) — lets a
    static-shape scan process only the newly-arrived tail of a region,
    the reference's one-pass-per-sample semantics.

    x [..., W] -> (fires bool [..., W], state [...], holding [...]).
    """
    sq = x * x
    if state is None:
        state = jnp.full(x.shape[:-1], threshold * threshold, x.dtype)
    if holding is None:
        holding = jnp.zeros(x.shape[:-1], bool)
    thr2 = threshold * threshold

    def step(carry, sv):
        st, hold = carry
        s, v = sv
        delta = s - st
        falling = delta < 0
        fire = falling & hold & v
        new_hold = jnp.where(
            v, jnp.where(falling, False, hold | (delta > hysteresis * st)), hold
        )
        new_st = jnp.where(
            v, jnp.where(falling, jnp.maximum(thr2, st * decay), s), st
        )
        return (new_st, new_hold), fire

    xt = jnp.moveaxis(sq, -1, 0)
    if valid is None:
        vt = jnp.ones((x.shape[-1],), bool)
    else:
        vt = jnp.broadcast_to(jnp.asarray(valid, bool), (x.shape[-1],))
    (state, holding), fires = jax.lax.scan(step, (state, holding), (xt, vt))
    # the fire marks "first sample that no longer qualifies"; the event
    # timestamp is the previous sample (ref: peaks.push(... - 1))
    fires = jnp.moveaxis(fires, 0, -1)
    boundary = fires[..., 0]
    fires = jnp.concatenate([fires[..., 1:], jnp.zeros_like(fires[..., :1])], axis=-1)
    # a fall at sample 0 times the event at the PREVIOUS block's last
    # sample (holding carried across the boundary); clamp it to sample 0
    # rather than dropping the trigger — one sample of skew beats a lost
    # retrigger/phase slip in envelope-hold mode
    fires = fires.at[..., 0].set(fires[..., 0] | boundary)
    return fires, state, holding


# ---------------------------------------------------------------------------
# spectral trigger
# ---------------------------------------------------------------------------


class BinRecord(NamedTuple):
    """Fundamental candidate (ref: OscilloscopeDSP.inl BinRecord)."""

    index: jax.Array  # int32
    value: jax.Array  # f32 magnitude
    offset: jax.Array  # f32 fractional bin offset

    def omega(self):
        return self.index.astype(jnp.float32) + self.offset


def _quad_delta(spec: jax.Array) -> jax.Array:
    """Complex quadratic interpolation of the true peak offset per bin
    (ref: OscilloscopeDSP.inl:103-126): Re((X[w-1]-X[w+1]) /
    (2 X[w] - X[w-1] - X[w+1])), with bin 0 mirroring bin 1."""
    n = spec.shape[-1]
    xm1 = jnp.concatenate([spec[..., 1:2], spec[..., :-1]], axis=-1)
    x1 = jnp.roll(spec, -1, axis=-1)
    denom = spec * 2.0 - xm1 - x1
    ok = (denom.real + denom.imag) != 0
    ratio = (xm1 - x1) / jnp.where(ok, denom, 1.0)
    return jnp.where(ok, ratio.real, 0.0)


def spectral_fundamental(
    x: jax.Array,
    sample_rate: float,
    *,
    threshold: float = 0.0,
    hysteresis: float = 0.0,
) -> Tuple[jax.Array, jax.Array, BinRecord]:
    """Estimate the dominant fundamental of a lookahead buffer
    (ref: calculateFundamentalPeriod, OscilloscopeDSP.inl:80-225).

    x [..., N] real (N = LOOKAHEAD_SIZE in the reference). Returns
    (fundamental_hz [...], cycle_samples [...], BinRecord).

    Candidate walk semantics: a bin must beat the incumbent by 2x (scaled
    by 1-hysteresis); a 20x winner always takes over; a candidate within a
    quarter semitone of the incumbent is a better estimate of the same
    partial; a candidate harmonically related to the incumbent (within a
    quarter semitone of an integer ratio) is rejected.
    """
    n = x.shape[-1]
    # real input: only bins [0, n/2] are ever read (candidate walk stops
    # at n/2, quad interpolation reads one neighbour past it) — rfft does
    # half the transform work of the reference's complex fft here.
    # _quad_delta's roll wraps bin 0 into the last slot, but that only
    # perturbs bin n/2's offset, which no consumer reads.
    spec = jnp.fft.rfft(x, axis=-1)
    mags = jnp.abs(spec)
    offsets = _quad_delta(spec)

    quarter_semitone = 2.0 ** (0.25 / 12.0) - 1.0
    inv_h = 1.0 - hysteresis

    batch_shape = x.shape[:-1]
    init = BinRecord(
        index=jnp.full(batch_shape, 1, jnp.int32),
        value=jnp.maximum(threshold * n / 6.0, mags[..., 1]),
        offset=offsets[..., 1],
    )

    half = n // 2
    idxs = jnp.arange(2, half, dtype=jnp.int32)
    vals = mags[..., 2:half]  # [..., M]
    offs = offsets[..., 2:half]
    omegas = idxs.astype(jnp.float32) + offs

    # The walk is sequential only at ACCEPTANCES: between two acceptances
    # the incumbent is constant, so the accept test for every later bin can
    # be evaluated against it in one vectorized pass, and the next
    # acceptance is the first True. Iterate acceptance-to-acceptance with a
    # while_loop (race-to-next-record) instead of scanning all ~N/2 bins:
    # each accepted value must exceed 2x the previous, so float32's full
    # dynamic range (smallest subnormal 2^-149 -> f32 max 2^128) bounds
    # the chain at <= 277 doublings — the loop runs ~chain-length
    # iterations of [batch, M] vector work rather than N/2 dependent steps
    # of scalar-carry work.
    # Semantics identical to the reference's per-bin loop
    # (OscilloscopeDSP.inl:134-184).
    def accept_mask(record: BinRecord):
        cur_val = vals
        max_omega = record.omega()[..., None]
        vastly_better = inv_h * cur_val > record.value[..., None] * 2.0
        factor = omegas / jnp.where(max_omega > 0, max_omega, 1.0)
        sensitivity = cur_val / jnp.maximum(record.value[..., None], 1e-30)
        twenty_x = inv_h * sensitivity > 20.0
        same_partial = jnp.abs(1.0 - factor) < inv_h * quarter_semitone
        mult_dev = jnp.abs(factor - jnp.floor(factor + 0.5))
        not_harmonic = inv_h * mult_dev > quarter_semitone
        accept_with_positive = twenty_x | same_partial | not_harmonic
        accept = vastly_better & jnp.where(max_omega > 0, accept_with_positive, True)
        # only bins the sequential walk has not yet passed are eligible
        return accept & (idxs > record.index[..., None])

    def cond(carry):
        record, active, it = carry
        return jnp.any(active) & (it < 280)  # > the 277-doubling f32 bound

    def body(carry):
        record, _, it = carry
        acc = accept_mask(record)  # [..., M]
        any_acc = jnp.any(acc, axis=-1)
        first = jnp.argmax(acc, axis=-1)  # first True (0 when none)
        new = BinRecord(
            index=jnp.where(any_acc, jnp.take(idxs, first), record.index),
            value=jnp.where(
                any_acc, jnp.take_along_axis(vals, first[..., None], -1)[..., 0], record.value
            ),
            offset=jnp.where(
                any_acc, jnp.take_along_axis(offs, first[..., None], -1)[..., 0], record.offset
            ),
        )
        return new, any_acc, it + 1

    active0 = jnp.ones(batch_shape, bool)
    record, _, _ = jax.lax.while_loop(cond, body, (init, active0, jnp.int32(0)))
    fundamental = sample_rate * record.omega() / n
    fundamental = jnp.maximum(5.0, fundamental)  # ref: :221 floor at 5 Hz
    cycle_samples = sample_rate / fundamental
    return fundamental, cycle_samples, record


def median_record_filter(
    history_omega: jax.Array, record: BinRecord
) -> Tuple[jax.Array, BinRecord, jax.Array]:
    """8-deep median-by-bin filter over detected fundamentals
    (ref: OscilloscopeDSP.inl:187-213). history_omega [..., 8] holds past
    omegas (the reference keys the median on the integer bin; we use omega,
    equivalent ordering up to the sub-bin offset). Returns (new_history,
    filtered_record_omega_as_record, use_median flag folded in)."""
    # the reference computes the median over the history BEFORE inserting
    # the new detection ("copy old filter" then "store new data"), takes
    # the single upper-middle element (nth_element at FilterSize/2 — NOT
    # an average of the two middles, which would blend the -1 "not yet
    # populated" sentinels into a fundamental that does not exist), and
    # skips the override while that element is a sentinel
    middle = history_omega.shape[-1] // 2
    med = jnp.sort(history_omega, axis=-1)[..., middle]
    hist = jnp.concatenate([history_omega[..., 1:], record.omega()[..., None]], axis=-1)
    use_median = (med >= 0) & (jnp.abs(record.omega() - med) > 0.5)
    omega = jnp.where(use_median, med, record.omega())
    filtered = BinRecord(
        index=jnp.floor(omega).astype(jnp.int32),
        value=record.value,
        offset=omega - jnp.floor(omega),
    )
    return hist, filtered, use_median


def goertzel(x: jax.Array, radians: jax.Array) -> jax.Array:
    """Single-frequency DFT correlate: sum x[n] e^{-i r n}
    (ref: cpl dsp::goertzel usage at OscilloscopeDSP.inl:277). The classic
    recursive Goertzel saves multiplies on a CPU; on an accelerator the
    direct complex dot product is a single fused reduce."""
    n = x.shape[-1]
    k = jnp.arange(n, dtype=x.dtype)
    phases = radians[..., None] * k
    return jnp.sum(x * jnp.exp(-1j * phases.astype(jnp.complex64)), axis=-1)


def trigger_phase_offset(
    lookahead: jax.Array,
    omega: jax.Array,
    cycle_samples: jax.Array,
    effective_window: jax.Array,
    sample_rate: float,
    fundamental: jax.Array,
    bin_offset: jax.Array,
    phase_offset_degrees: float = 0.0,
) -> jax.Array:
    """Phase-lock sample offset via Goertzel + DFT shift theorem
    (ref: calculateTriggeringOffset, OscilloscopeDSP.inl:230-308).

    lookahead [..., N]: the most recent N samples (newest last). Returns
    the fractional sample offset that phase-locks the waveform on screen.
    """
    n = lookahead.shape[-1]
    tau = 2.0 * math.pi
    radians = tau * omega / n

    # Our Goertzel buffer is anchored at exactly -N (the newest N
    # samples). The reference instead reads N samples from
    # -ceil(max(N, window+cycles)) and corrects the phase by
    # ceil(.) - (window+cycles) (OscilloscopeDSP.inl:263-270); relative
    # to OUR fixed anchor the equivalent correction is exactly
    # N - (window + cycles) — no max/ceil. (Round-3 review: carrying the
    # reference's max/ceil form verbatim silently broke the phase lock
    # whenever window + cycles exceeded the lookahead, because the two
    # buffers then start D = ceil(window+cycles) - N samples apart.)
    sample_difference = float(n) - (effective_window + cycle_samples)

    z = goertzel(lookahead, radians)
    rotation = -sample_difference * radians
    z = z * jnp.exp(-1j * rotation.astype(jnp.complex64))

    phase = tau - jnp.angle(z)
    phase = phase + bin_offset * tau
    phase = phase - tau / 4.0
    phase = phase + tau * phase_offset_degrees / 360.0
    phase = jnp.mod(jnp.mod(phase, tau) + tau, tau)
    cycles = phase / tau
    return cycles * sample_rate / fundamental - 1.0


# ---------------------------------------------------------------------------
# display resampling
# ---------------------------------------------------------------------------


def sinc_resample(
    x: jax.Array,
    start: jax.Array,
    step: jax.Array,
    num_out: int,
    kernel_size: int = INTERPOLATION_KERNEL_SIZE,
) -> jax.Array:
    """Windowed-sinc (Lanczos) fractional resampling to pixel space
    (ref: drawWavePlot Lanczos path, OscilloscopeRendering.cpp:854-888;
    kernel size 10 per OscilloscopeParameters.h:47).

    x [..., W]; output pixel p samples position start + p*step. Edge taps
    clamp to the frame. Returns [..., num_out].

    Per-tap gather: each output pixel reads its 2a source taps and
    weights them in the same fused loop, so no weight grid is written to
    device memory. Measured on the GPU against block-banded matmul forms
    at the oscilloscope geometries, the gather was the fastest (see
    PERF.md), and it is exact for any step.
    """
    a = kernel_size
    w = x.shape[-1]
    p = jnp.arange(num_out, dtype=jnp.float32)
    start = jnp.asarray(start, jnp.float32)
    step = jnp.asarray(step, jnp.float32)
    pos = start[..., None] + p * step[..., None]  # [..., P]
    # tap-clip equivalence holds for positions up to a kernel radius
    # outside the frame (the processor clamps its window into the frame)
    pos = jnp.clip(pos, -(a + 1.0), w - 1.0 + a)
    i0 = jnp.floor(pos)
    offs = jnp.arange(-a + 1, a + 1, dtype=jnp.float32)  # 2a taps
    tap_pos = i0[..., None] + offs  # [..., num_out, 2a]
    t = pos[..., None] - tap_pos
    sinc = jnp.sinc(t) * jnp.sinc(t / a)
    weights = jnp.where(jnp.abs(t) < a, sinc, 0.0)
    idx = jnp.clip(tap_pos.astype(jnp.int32), 0, w - 1)
    return jnp.sum(_gather_last(x, idx) * weights, axis=-1)


def _gather_last(x: jax.Array, idx: jax.Array) -> jax.Array:
    """Gather x[..., W] at idx [..., num_out, taps] -> [..., num_out, taps].
    Batch dims of x and idx broadcast against each other."""
    flat_idx = idx.reshape(idx.shape[:-2] + (-1,))
    g = jnp.take_along_axis(x, flat_idx, axis=-1)
    return g.reshape(g.shape[:-1] + idx.shape[-2:])


def linear_resample(x: jax.Array, start, step, num_out: int) -> jax.Array:
    """2-tap linear variant (ref: SubSampleInterpolation::Linear path)."""
    w = x.shape[-1]
    p = jnp.arange(num_out, dtype=jnp.float32)
    start = jnp.asarray(start, jnp.float32)
    step = jnp.asarray(step, jnp.float32)
    pos = start[..., None] + p * step[..., None]
    pos = jnp.clip(pos, -2.0, w * 1.0)
    i0 = jnp.floor(pos)
    frac = pos - i0
    idx = jnp.stack([i0, i0 + 1], axis=-1).astype(jnp.int32)
    g = _gather_last(x, jnp.clip(idx, 0, w - 1))
    return g[..., 0] * (1 - frac) + g[..., 1] * frac


def nearest_resample(x: jax.Array, start, step, num_out: int) -> jax.Array:
    """Nearest-sample pick (ref: SubSampleInterpolation::None /
    Rectangular); exact .5 ties resolve upward (floor(pos + 0.5))."""
    w = x.shape[-1]
    p = jnp.arange(num_out, dtype=jnp.float32)
    start = jnp.asarray(start, jnp.float32)
    step = jnp.asarray(step, jnp.float32)
    pos = start[..., None] + p * step[..., None]
    pos = jnp.clip(pos, -1.0, w * 1.0)
    idx = jnp.clip(jnp.floor(pos + 0.5).astype(jnp.int32), 0, w - 1)
    return _gather_last(x, idx[..., None])[..., 0]


def minmax_decimate(x: jax.Array, num_out: int) -> Tuple[jax.Array, jax.Array]:
    """Min-max peak decimation: x [..., W] -> (mins, maxs) each
    [..., num_out], pixel p reducing samples [p*W/P, (p+1)*W/P).

    The reference renders rectangular line strips in sample space when
    zoomed out; here we reduce to per-pixel envelopes so the vertex count
    stays bounded by the display width (BASELINE config 3)."""
    w = x.shape[-1]
    if w % num_out == 0:
        r = x.reshape(x.shape[:-1] + (num_out, w // num_out))
        return r.min(-1), r.max(-1)
    # non-divisible: pad with edge values to the next multiple
    k = -(-w // num_out)
    pad = k * num_out - w
    xp = jnp.concatenate([x, jnp.repeat(x[..., -1:], pad, axis=-1)], axis=-1)
    r = xp.reshape(x.shape[:-1] + (num_out, k))
    return r.min(-1), r.max(-1)


# ---------------------------------------------------------------------------
# spectral colouring
# ---------------------------------------------------------------------------


def spectral_colour_track(
    bands: jax.Array,
    smooth_pole,
    band_colours: jax.Array,
    key_colour: jax.Array,
    blend,
    smooth_state: jax.Array = None,
) -> Tuple[jax.Array, jax.Array]:
    """Per-sample 3-band energy colouring (ref: OscilloscopeDSP.inl:460-494
    filterStates/accumulateColour).

    bands [..., 3, W] (from :func:`signalizer_tpu.kernels.filters.three_band_split`);
    band_colours [3, 3] rgb rows for low/mid/high; key_colour [..., 3];
    blend in [0, 1] = weight of the energy colour vs the key colour
    (the reference lerps with 1 - frequencyColouringBlend).

    Per sample: smooth band energy s[b] = band^2 + pole (s[b] - band^2),
    rgb = sum_b s[b] * colour[b], normalized so max(r,g,b) = 1, then
    lerped toward the key colour. Returns (colours [..., W, 3], final
    smooth state [..., 3]).
    """
    from signalizer_tpu.kernels.filters import onepole_smooth

    sq = bands * bands  # [..., 3, W]
    smoothed = onepole_smooth(sq, smooth_pole, smooth_state)  # [..., 3, W]
    rgb = jnp.einsum(
        "...bw,bc->...wc", smoothed, band_colours,
        precision=jax.lax.Precision.HIGHEST,
    )  # [..., W, 3]
    peak = jnp.max(rgb, axis=-1, keepdims=True)
    rgb = rgb / jnp.maximum(peak, 1e-20)
    rgb = jnp.where(peak > 0, rgb, 0.0)
    out = key_colour[..., None, :] + (rgb - key_colour[..., None, :]) * blend
    return out, smoothed[..., -1]


def sinc_resample_matrix(
    window: int,
    start: float,
    step: float,
    num_out: int,
    kernel_size: int = INTERPOLATION_KERNEL_SIZE,
) -> jnp.ndarray:
    """Precompute the resampling as a dense [window, num_out] matrix for
    *static* positions (host-side, once per configuration).

    For a fixed pixel grid the windowed-sinc resample is a constant linear
    map, applied as one matmul (bench cfg5's fused step uses it).
    """
    import numpy as np

    a = kernel_size
    pos = start + np.arange(num_out) * step
    i0 = np.floor(pos)
    offs = np.arange(-a + 1, a + 1)
    taps = i0[:, None] + offs[None, :]
    t = pos[:, None] - taps
    wts = np.sinc(t) * np.sinc(t / a)
    wts = np.where(np.abs(t) < a, wts, 0.0)
    idx = np.clip(taps.astype(np.int64), 0, window - 1)
    mat = np.zeros((window, num_out), np.float32)
    for p in range(num_out):
        for k in range(2 * a):
            mat[idx[p, k], p] += wts[p, k]
    return jnp.asarray(mat)


def sinc_resample_static(x: jax.Array, matrix: jax.Array) -> jax.Array:
    """Apply a precomputed resample matrix: x [..., W] @ [W, P] -> [..., P].

    Full f32 precision: a reduced-precision product (bf16 or TF32) costs
    visible waveform fuzz; HIGHEST keeps the resample exact to float32.
    """
    return jnp.einsum(
        "...w,wp->...p", x, matrix, precision=jax.lax.Precision.HIGHEST
    )
