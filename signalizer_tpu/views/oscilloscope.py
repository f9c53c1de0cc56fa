"""OscilloscopeProcessor — the stateful public face of the oscilloscope.

Plays the role of the reference's Oscilloscope StreamState + render-thread
trigger analysis + drawWavePlot (ref: Source/Oscilloscope/Oscilloscope.cpp,
OscilloscopeDSP.inl, OscilloscopeRendering.cpp:560-891). Rendering is out
of scope; outputs are render-ready pixel-space arrays.

Design differences from the reference (deliberate):

* The reference's EnvelopeHold/ZeroCrossing modes chop the *stream* with a
  double-buffer swap state machine (StreamPreprocessing.h:78-206) that has
  known concurrency bugs (reference Source/Notes/Bugs.txt). Here the
  processor reads windows out of a continuous history tensor and *centers
  the display window on the latest detected trigger* — same observable
  behavior (a trigger-locked, hold-style display), no buffer swaps, no
  races, and it batches across channel pairs.
* All per-configuration scalars live in one frozen
  :class:`OscilloscopeConstant` pytree (pattern:
  ``core/constant.py`` SpectrumConstant). Only fields that change control
  flow or shapes are static jit keys; thresholds, colours, gains etc. are
  device leaves, so dragging those knobs neither recompiles nor re-hashes
  a long static-kwargs tuple per dispatch.
* The RMS autogain envelope (ref: OscilloscopeDSP.inl:505-698 — per-sample
  one-pole over the squared channel-mode signal) is a closed-form block
  update: ``env' = c^n env + (1-c) * sum_k c^(n-1-k) x_k^2`` evaluated as
  one masked weighted reduction over the history, instead of a sequential
  scan. MidSide parity note: the reference smooths ``0.5*(l±r)^2``
  (OscilloscopeDSP.inl:573-580) where the display rows are ``0.5*(l±r)``,
  so the squared rows are scaled by 2 in that mode to match.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from signalizer_tpu.core.config import OscChannels
from signalizer_tpu.core.constant import HostMirror
from signalizer_tpu.params.transformatters import TimeMode
from signalizer_tpu.kernels.filters import (
    CrossoverState,
    init_crossover_state,
    three_band_split,
)
from signalizer_tpu.kernels.oscilloscope import (
    BinRecord,
    INTERPOLATION_KERNEL_SIZE,
    MEDIAN_FILTER_SIZE,
    zero_crossing_triggers,
    linear_resample,
    median_record_filter,
    nearest_resample,
    peak_hold_triggers,
    sinc_resample,
    spectral_colour_track,
    spectral_fundamental,
    trigger_phase_offset,
)


class TriggerMode(enum.IntEnum):
    """ref: OscilloscopeParameters.h:50-58."""

    NONE = 0
    SPECTRAL = 1
    WINDOW = 2
    ENVELOPE_HOLD = 3
    ZERO_CROSSING = 4


class SubSampleInterpolation(enum.IntEnum):
    """ref: OscilloscopeParameters.h sampleInterpolation."""

    NONE = 0
    RECTANGULAR = 1
    LINEAR = 2
    LANCZOS = 3


class AutoGain(enum.IntEnum):
    """ref: OscilloscopeParameters.h:424 autoGain {None, RMS, Peak decay}."""

    NONE = 0
    RMS = 1
    PEAK_DECAY = 2


def _static():
    return dataclasses.field(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class OscilloscopeConstant:
    """Immutable oscilloscope configuration pytree.

    The oscilloscope analogue of :class:`SpectrumConstant`
    (ref: the flag-guarded members of Oscilloscope::StreamState,
    Oscilloscope.cpp:236-308). Static fields change compiled control flow
    or shapes; array leaves retune without recompiling.
    """

    # --- static (jit key) ---------------------------------------------------
    channel_mode: OscChannels = _static()
    trigger_mode: TriggerMode = _static()
    interpolation: SubSampleInterpolation = _static()
    pixels: int = _static()
    lookahead: int = _static()
    sample_rate: float = _static()
    autogain: AutoGain = _static()
    colour_enabled: bool = _static()
    custom_trigger: bool = _static()  # ref: OscilloscopeDSP.inl:69-78
    trigger_channel: int = _static()

    # --- array leaves ---------------------------------------------------------
    threshold: jax.Array  # scalar f32
    hysteresis: jax.Array  # scalar f32
    phase_degrees: jax.Array  # scalar f32
    envelope_ln_pole: jax.Array  # scalar f32: ln c, c = exp(-1/(win_s*fs))
    colour_pole: jax.Array  # scalar f32
    band_colours: jax.Array  # [3, 3] low/mid/high rgb
    key_colours: jax.Array  # [2, 3] primary/secondary rgb per row
    colour_blend: jax.Array  # scalar f32
    manual_gain: jax.Array  # scalar f32
    custom_trigger_frequency: jax.Array  # scalar f32 Hz

    # host mirror as STATIC aux data (core.constant.HostMirror): survives
    # dataclasses.replace / tree_map / jit round-trips, unlike a stapled
    # attribute, so make_pair_key_colours reads host values without
    # waiting on the device
    host_data: Optional[HostMirror] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    @property
    def rows(self) -> int:
        return 2 if self.channel_mode in (OscChannels.SEPARATE, OscChannels.MIDSIDE) else 1


def make_oscilloscope_constant(
    *,
    sample_rate: float = 48_000.0,
    channel_mode: OscChannels = OscChannels.SEPARATE,
    trigger_mode: TriggerMode = TriggerMode.NONE,
    interpolation: SubSampleInterpolation = SubSampleInterpolation.LANCZOS,
    pixels: int = 1024,
    lookahead: int = 8192,
    trigger_threshold: float = 0.0,
    trigger_hysteresis: float = 0.0,
    trigger_phase_degrees: float = 0.0,
    autogain: Union[AutoGain, bool, int] = AutoGain.NONE,
    envelope_window_ms: float = 1000.0,
    colour_enabled: bool = False,
    colour_smooth_ms: float = 10.0,
    band_colours=((1.0, 0.1, 0.1), (0.1, 1.0, 0.1), (0.1, 0.1, 1.0)),
    key_colour=(1.0, 1.0, 1.0),
    secondary_colour=None,
    colour_blend: float = 1.0,
    manual_gain: float = 1.0,
    trigger_channel: int = 0,
    custom_trigger: bool = False,
    custom_trigger_frequency: float = 440.0,
) -> OscilloscopeConstant:
    if isinstance(autogain, bool):
        autogain = AutoGain.PEAK_DECAY if autogain else AutoGain.NONE
    # ref: SmoothedParameterState-designed pole over colour_smooth_ms
    n = max(colour_smooth_ms * 1e-3 * sample_rate, 1.0)
    colour_pole = float(np.exp(-1.0 / n))
    # envelope one-pole (ref: OscilloscopeDSP.inl:448/:747 envelopeCoeff)
    env_n = max(envelope_window_ms * 1e-3 * sample_rate, 1.0)
    key = np.asarray(key_colour, np.float32)
    second = np.asarray(
        secondary_colour if secondary_colour is not None else key_colour, np.float32
    )
    constant = OscilloscopeConstant(
        channel_mode=OscChannels(channel_mode),
        trigger_mode=TriggerMode(trigger_mode),
        interpolation=SubSampleInterpolation(interpolation),
        pixels=int(pixels),
        lookahead=int(lookahead),
        sample_rate=float(sample_rate),
        autogain=AutoGain(autogain),
        colour_enabled=bool(colour_enabled),
        custom_trigger=bool(custom_trigger),
        trigger_channel=int(trigger_channel),
        threshold=jnp.asarray(trigger_threshold, jnp.float32),
        hysteresis=jnp.asarray(trigger_hysteresis, jnp.float32),
        phase_degrees=jnp.asarray(trigger_phase_degrees, jnp.float32),
        envelope_ln_pole=jnp.asarray(-1.0 / env_n, jnp.float32),
        colour_pole=jnp.asarray(colour_pole, jnp.float32),
        band_colours=jnp.asarray(band_colours, jnp.float32),
        key_colours=jnp.stack([jnp.asarray(key, jnp.float32), jnp.asarray(second, jnp.float32)]),
        colour_blend=jnp.asarray(colour_blend, jnp.float32),
        manual_gain=jnp.asarray(manual_gain, jnp.float32),
        custom_trigger_frequency=jnp.asarray(custom_trigger_frequency, jnp.float32),
        # host mirror — see core.constant.host_view
        host_data=HostMirror.of(
            key_colours=np.stack([key[:3], second[:3]]).astype(np.float64)
        ),
    )
    return constant


PEAK_QUEUE_SIZE = 8  # pending envelope-hold fires tracked across steps
# (the reference's TriggeringProcessor peak queue, StreamPreprocessing.h:78)
_FIRE_AGE_NONE = 1.0e9  # sentinel age for an empty queue slot


class OscilloscopeState(NamedTuple):
    """Carried device state."""

    peak_env: jax.Array  # [pairs, rows] autogain envelope (peak^2 or RMS)
    peak_hold_state: jax.Array  # [pairs] envelope-hold tracker
    peak_holding: jax.Array  # [pairs] bool
    median_history: jax.Array  # [pairs, 8] past fundamental omegas
    crossover: CrossoverState  # [pairs, rows, ...] colour network states
    colour_smooth: jax.Array  # [pairs, rows, 3] band smoothing states
    peak_fire_ages: jax.Array  # [pairs, PEAK_QUEUE_SIZE] samples since the
    # most recent envelope-hold fires (ascending after top_k; _FIRE_AGE_NONE
    # = empty slot)


class OscilloscopeFrame(NamedTuple):
    """Render-ready outputs."""

    waveform: jax.Array  # [pairs, rows, pixels] resampled values (gain applied)
    envelope_min: jax.Array  # [pairs, rows, pixels] min-max decimation
    envelope_max: jax.Array
    colours: jax.Array  # [pairs, rows, pixels, 3]
    gain: jax.Array  # [pairs]
    fundamental: jax.Array  # [pairs] (spectral mode; else 0)
    trigger_found: jax.Array  # [pairs] bool


def _pack_rows(frames: jax.Array, mode: OscChannels) -> jax.Array:
    """history [pairs, 2, H] -> display rows [pairs, rows, H]
    (ref: SampleColourEvaluators.h channel-mode evaluators)."""
    left = frames[..., 0, :]
    right = frames[..., 1, :]
    if mode == OscChannels.LEFT:
        return left[..., None, :]
    if mode == OscChannels.RIGHT:
        return right[..., None, :]
    if mode == OscChannels.MERGE:
        return ((left + right) * 0.5)[..., None, :]
    if mode == OscChannels.SIDE:
        return ((left - right) * 0.5)[..., None, :]
    if mode == OscChannels.SEPARATE:
        return frames
    if mode == OscChannels.MIDSIDE:
        return jnp.stack([(left + right) * 0.5, (left - right) * 0.5], axis=-2)
    raise ValueError(mode)


def make_pair_key_colours(constant, pairs: int):
    """Hue-rotated key-colour table for multi-pair draws, or None for a
    single pair (ref: CHANGELOG 0.4.0 / ColourRotation). The one canonical
    builder — the sharded step (parallel/mesh.py) and the single-device
    processor must agree on the rotation rule (review finding: a private
    duplicate in mesh.py could drift)."""
    if pairs <= 1:
        return None
    from signalizer_tpu.core.constant import host_view
    from signalizer_tpu.utils.colour import pair_key_table

    kc = host_view(constant, "key_colours")
    return jnp.asarray(pair_key_table(kc[0], kc[1], pairs))


class OscilloscopeProcessor:
    """Stateful oscilloscope engine over batched channel pairs.

    ``process(history)`` takes a [pairs, 2, H] history tensor (newest
    sample last; H static) and returns an :class:`OscilloscopeFrame`.
    """

    def __init__(
        self,
        constant: Optional[OscilloscopeConstant] = None,
        *,
        pairs: int = 1,
        window_samples: float = 1024.0,  # effectiveWindowSize
        time_mode: "TimeMode" = None,
        window_value: Optional[float] = None,
        bpm: float = 120.0,
        bpm_source=None,
        **constant_kwargs,
    ):
        if constant is None:
            constant = make_oscilloscope_constant(**constant_kwargs)
        elif constant_kwargs:
            raise ValueError("pass either a constant or kwargs, not both")
        self.constant = constant
        self.pairs = pairs
        self.window_samples = float(window_samples)
        # live time modes (ref: Oscilloscope.cpp:293-308): Beats derives the
        # window from the playhead bpm each call; Cycles feeds the *detected*
        # cycleSamples of the previous spectral analysis back in
        self.time_mode = TimeMode.TIME if time_mode is None else TimeMode(time_mode)
        self.window_value = None if window_value is None else float(window_value)
        self.bpm = float(bpm)
        self.bpm_source = bpm_source  # callable returning the live bpm
        self._last_cycle_samples = 0.0
        self._cycle_window_dev = None  # device-resident Cycles window chain
        self._cycle_samples_dev = None
        # per-call scalar args are cached on device: re-uploading three tiny
        # scalars every dispatch costs one host->device copy each
        self._scalar_cache: dict = {}
        # transport changes every playing frame — a one-slot cache keeps it
        # from churning the stable window/new_samples entries above
        self._transport_cache: Optional[tuple] = None
        self._pair_keys = self._make_pair_keys()
        self._state = self._init_state()

    def _make_pair_keys(self):
        return make_pair_key_colours(self.constant, self.pairs)

    # legacy attribute views (round-1 public surface)
    @property
    def sample_rate(self) -> float:
        return self.constant.sample_rate

    @property
    def pixels(self) -> int:
        return self.constant.pixels

    @property
    def channel_mode(self) -> OscChannels:
        return self.constant.channel_mode

    @property
    def trigger_mode(self) -> TriggerMode:
        return self.constant.trigger_mode

    @property
    def rows(self) -> int:
        return self.constant.rows

    def _init_state(self) -> OscilloscopeState:
        # no device->host readback here (e.g. float(threshold)): it would
        # wait for the device; threshold^2 stays device-side.
        pairs, rows = self.pairs, self.constant.rows
        thr2 = jnp.broadcast_to(jnp.square(self.constant.threshold), (pairs,))
        return OscilloscopeState(
            peak_env=jnp.zeros((pairs, rows), jnp.float32),
            peak_hold_state=thr2.astype(jnp.float32),
            peak_holding=jnp.zeros((pairs,), bool),
            median_history=jnp.full((pairs, MEDIAN_FILTER_SIZE), -1.0, jnp.float32),
            crossover=init_crossover_state((pairs, rows)),
            colour_smooth=jnp.zeros((pairs, rows, 3), jnp.float32),
            peak_fire_ages=jnp.full(
                (pairs, PEAK_QUEUE_SIZE), _FIRE_AGE_NONE, jnp.float32
            ),
        )

    @property
    def state(self) -> OscilloscopeState:
        return self._state

    def reset(self) -> None:
        self._state = self._init_state()

    def reconfigure(self, constant: OscilloscopeConstant) -> None:
        """Swap configuration; resets state when shapes change
        (ref: handleFlagUpdates' deferred resets, Oscilloscope.cpp:236-308)."""
        old_rows = self.constant.rows
        self.constant = constant
        self._pair_keys = self._make_pair_keys()  # key colours may differ
        if constant.rows != old_rows:
            self._state = self._init_state()

    def process(
        self,
        history,
        transport_position: float = 0.0,
        new_samples: Optional[int] = None,
    ) -> OscilloscopeFrame:
        """Analyze one history snapshot.

        ``new_samples``: how many trailing samples arrived since the last
        call — drives the autogain envelope advance (RMS one-pole / peak
        decay). Defaults to the full history (every call sees fresh data).
        """
        if not isinstance(history, jax.Array):
            history = jnp.asarray(history, jnp.float32)
        if new_samples is None:
            new_samples = history.shape[-1]
        prep = self._prep_step(history.shape[-1], transport_position, new_samples)
        window_dev, transport_dev, ns_dev, chunk, env_os, cycles_live = prep
        frame, self._state = _osc_step(
            self.constant, self._state, history,
            window_dev,
            transport_dev,
            ns_dev,
            self._pair_keys,
            trigger_chunk=chunk,
            env_os=env_os,
        )
        if cycles_live:
            self._post_cycle_feedback(frame)
        return frame

    def _prep_step(self, h: int, transport_position: float, new_samples: int):
        """Host-side static/scalar prep shared by :meth:`process` and the
        session's fused all-views tick — ONE source of truth, so the two
        paths pick identical pow2 buckets/scalars and stay bit-equal
        (and share the same jit-variant ladder)."""
        cycles_live = (
            self.time_mode == TimeMode.CYCLES
            and self.constant.trigger_mode == TriggerMode.SPECTRAL
        )
        # per-value scalar caches: window and new_samples are stable across
        # live frames (cache hits); transport changes every playing frame,
        # so its upload is inherent — a one-slot cache keeps it from
        # evicting the stable ones. When the live-cycles feedback chain is
        # active the window stays device-resident — do NOT call
        # effective_window_samples() here: its Cycles branch reads the
        # detected cycleSamples back to the host, which would make every
        # tick wait for the previous one's device work
        px = max(self.constant.pixels - 1, 1)
        if cycles_live and self._cycle_window_dev is not None:
            window_dev = self._cycle_window_dev
            # window is device-resident (never read back) — keep the
            # conservative envelope oversampling bound
            env_os = None
        else:
            window = (
                self.window_samples
                if self.time_mode == TimeMode.TIME
                else self.effective_window_samples(sync_device=False)
            )
            window_dev = self._dev_scalar(float(window))
            # static envelope oversampling from the host-known window:
            # pow2 bucket of the actual per-pixel step (bounds retraces
            # to log2 variants), never above the conservative bound
            step_bound = max(1.0, (min(float(window), h) - 1.0) / px)
            bucket = 1 << (int(np.ceil(step_bound)) - 1).bit_length()
            # cap at the conservative bound ceil((h-1)/(px)) — NOT
            # ceil(h/pixels), which is fractionally below the true
            # fence-post step (h-1)/(pixels-1) when pixels divides h and
            # would skip source samples at window == h
            env_os = min(bucket, max(1, -(-(h - 1) // px)))
        if self.constant.trigger_mode == TriggerMode.ENVELOPE_HOLD:
            # pow2-bucketed static trigger scan over the new tail only —
            # O(new_samples) per tick instead of O(lookahead), at most
            # log2(lookahead) compiled variants (the RSNT/spectrogram
            # bucketing pattern)
            la = min(self.constant.lookahead, h)
            n = max(1, min(int(new_samples), la))
            chunk = min(1 << (n - 1).bit_length(), la)
        else:
            chunk = None
        return (
            window_dev,
            self._dev_transport(float(transport_position)),
            self._dev_scalar(float(int(new_samples))),
            chunk,
            env_os,
            cycles_live,
        )

    def _post_cycle_feedback(self, frame: "OscilloscopeFrame") -> None:
        """Feed the detected fundamental back into the next window
        (ref: triggerState.cycleSamples -> effectiveWindowSize,
        Oscilloscope.cpp:299-303) — computed ON DEVICE, so the tick never
        waits on a host readback."""
        v = self.window_value if self.window_value is not None else self.window_samples
        self._cycle_window_dev, self._cycle_samples_dev = _cycle_feedback(
            frame.fundamental,
            self._dev_scalar(float(v)),
            self._dev_scalar(self.constant.sample_rate),
        )

    def _dev_scalar(self, value: float) -> jax.Array:
        """Device-cached f32 scalar: saves a host->device copy of a tiny
        scalar per dispatch."""
        s = self._scalar_cache.get(value)
        if s is None:
            if len(self._scalar_cache) > 64:
                self._scalar_cache.clear()
            s = self._scalar_cache[value] = jnp.asarray(value, jnp.float32)
        return s

    def _dev_transport(self, value: float) -> jax.Array:
        """One-slot device cache for the transport position — it advances
        every playing frame, so routing it through the shared value cache
        would flush the stable window/new_samples scalars every ~64 frames."""
        c = self._transport_cache
        if c is None or c[0] != value:
            self._transport_cache = c = (value, jnp.asarray(value, jnp.float32))
        return c[1]

    def effective_window_samples(self, sync_device: bool = True) -> float:
        """The window actually displayed this frame, per time mode
        (ref: Oscilloscope.cpp:293-308).

        Cycles mode syncs the detected cycleSamples from the device — an
        explicit host readout for UI/formatting; the processing loop
        itself keeps the feedback device-resident and passes
        ``sync_device=False`` (a per-frame device→host readback would make
        each tick wait for the previous one's device work). Without the
        sync the last host-read value is used."""
        if self.time_mode == TimeMode.TIME:
            return self.window_samples
        v = self.window_value if self.window_value is not None else self.window_samples
        if self.time_mode == TimeMode.CYCLES:
            if sync_device and self._cycle_samples_dev is not None:
                self._last_cycle_samples = float(jax.device_get(self._cycle_samples_dev))
            return max(128.0, v * max(self._last_cycle_samples, 1.0) + 1.0)
        bpm = self.bpm_source() if self.bpm_source is not None else self.bpm
        return max(128.0, self.constant.sample_rate * 60.0 / (max(10.0, bpm) * max(v, 1e-9)))


def _autogain_update(
    constant: OscilloscopeConstant,
    env: jax.Array,
    rows: jax.Array,
    new_samples: jax.Array,
) -> Tuple[jax.Array, jax.Array]:
    """Advance the autogain envelope and derive the display gain.

    Peak decay (ref: runPeakFilter, OscilloscopeDSP.inl:712-886):
    ``env' = max(env * c^n, peak^2)``, gain ``1/sqrt(max_c env')``.

    RMS (ref: OscilloscopeDSP.inl:505-698): the per-sample one-pole
    ``env = x^2 + c (env - x^2)`` over the n new samples, in closed form:
    ``env' = c^n env + (1-c) sum_k c^(n-1-k) x_k^2``.
    """
    pairs = rows.shape[0]
    ln_c = constant.envelope_ln_pole
    if constant.autogain == AutoGain.PEAK_DECAY:
        peaks = jnp.max(jnp.abs(rows), axis=-1)  # [pairs, rows]
        pole = jnp.exp(ln_c * new_samples)
        new_env = jnp.maximum(env * pole, peaks**2)
    elif constant.autogain == AutoGain.RMS:
        sq = rows * rows
        if constant.channel_mode == OscChannels.MIDSIDE:
            sq = sq * 2.0  # ref smooths 0.5(l±r)^2; rows are 0.5(l±r)
        h = rows.shape[-1]
        k = jnp.arange(h, dtype=jnp.float32)
        age = (h - 1.0) - k
        # (1-c) c^age, zeroed for samples older than the new block
        w = jnp.exp(ln_c * age) * -jnp.expm1(ln_c)
        w = jnp.where(k >= h - new_samples, w, 0.0)
        contrib = jnp.einsum("prh,h->pr", sq, w, precision=jax.lax.Precision.HIGHEST)
        new_env = jnp.exp(ln_c * new_samples) * env + contrib
    else:
        g = jnp.ones((pairs,), jnp.float32) * constant.manual_gain
        return env, g
    g = 1.0 / jnp.sqrt(jnp.max(new_env, axis=-1))
    gain = jnp.where(jnp.isfinite(g) & (g > 0), g, 1.0) * constant.manual_gain
    return new_env, gain


def osc_step_impl(
    constant: OscilloscopeConstant,
    state: OscilloscopeState,
    history: jax.Array,
    window: jax.Array,
    transport_position: jax.Array,
    new_samples: jax.Array,
    pair_keys: Optional[jax.Array] = None,
    *,
    trigger_chunk: Optional[int] = None,
    env_os: Optional[int] = None,
) -> Tuple[OscilloscopeFrame, OscilloscopeState]:
    """Pure (unjitted) oscilloscope step — shard_map-able over the pairs
    axis (see :mod:`signalizer_tpu.parallel.mesh`).

    ``pair_keys`` [pairs, 2, 3]: per-pair hue-rotated primary/secondary
    colours (ref: CHANGELOG 0.4.0 multi-pair colour distinctness /
    ColourRotation); ``None`` = every pair uses the constant's colours.

    ``trigger_chunk`` (static): envelope-hold only — scan just the
    trailing ``trigger_chunk`` samples for triggers (must cover
    new_samples; ``process()`` picks a pow2 bucket). None = the full
    lookahead region, valid-masked to the new tail.

    ``env_os`` (static): per-pixel oversampling for the min-max envelope.
    The caller must guarantee ``env_os >= (window - 1) / (pixels - 1)``
    (the per-pixel sample step) or the envelope under-samples; None =
    the conservative ``ceil((h - 1) / (pixels - 1))`` bound, which is
    exact for any window but oversamples whenever the displayed window
    is shorter than history (``process()`` passes the pow2 bucket of
    the actual step instead)."""
    pairs, _, h = history.shape
    pixels = constant.pixels
    sample_rate = constant.sample_rate
    rows = _pack_rows(history, constant.channel_mode)  # [pairs, rows, H]
    # trigger channel selection (ref: calculateTriggerIndices,
    # OscilloscopeParameters.h:491-505)
    trig_src = rows[:, constant.trigger_channel % rows.shape[1], :]
    hf = jnp.asarray(float(h), jnp.float32)
    window = jnp.minimum(window, hf)

    fundamental = jnp.zeros((pairs,), jnp.float32)
    found = jnp.ones((pairs,), bool)
    new_median = state.median_history
    new_ph_state = state.peak_hold_state
    new_holding = state.peak_holding
    new_fire_ages = state.peak_fire_ages

    trigger_mode = constant.trigger_mode
    threshold = constant.threshold
    # --- trigger: fractional sample offset from the end of history --------
    if trigger_mode == TriggerMode.ZERO_CROSSING:
        la = min(constant.lookahead, h)
        region = trig_src[..., h - la :]
        fires = zero_crossing_triggers(region, threshold)
        # take the most recent trigger that still has a full half-window of
        # samples after it (the reference swaps buffers only once the half
        # window following the trigger is complete, StreamPreprocessing.h:78)
        fidx = jnp.arange(la, dtype=jnp.float32)
        pos_ok = (h - la) + fidx <= hf - window * 0.5
        last = jnp.max(jnp.where(fires & pos_ok, fidx, -1.0), axis=-1)
        found = last >= 0
        trigger_pos = (h - la) + jnp.maximum(last, 0.0)
        # center the window on the trigger; clamp into the history
        start = trigger_pos - (window - 1.0) * 0.5
        start = jnp.clip(start, 0.0, hf - window)
        start = jnp.where(found, start, hf - window)
    elif trigger_mode == TriggerMode.ENVELOPE_HOLD:
        # incremental consumption, the reference's semantics: the
        # TriggeringProcessor sees every sample exactly ONCE as it
        # arrives (StreamPreprocessing.h:270-312) — so only the
        # newly-arrived tail is scanned (valid-masked for static shapes;
        # ``trigger_chunk`` lets the caller shrink the scan to a bucket
        # of the tail, turning an O(lookahead) per-tick cost into
        # O(new_samples)). Earlier fires live on as AGES in a small
        # queue (the reference's pending-peak queue): each step they age
        # by new_samples, and the display picks the newest fire whose
        # half window is complete. Round-2..3 re-scanned the whole
        # region against the already-evolved state, which let the state
        # machine see samples twice with future-leaked state.
        la = min(constant.lookahead, h)
        chunk = la if trigger_chunk is None else max(1, min(trigger_chunk, la))
        region = trig_src[..., h - chunk :]
        idx = jnp.arange(chunk, dtype=jnp.float32)
        ns = jnp.clip(new_samples, 0.0, float(chunk))
        fires, new_ph_state, new_holding = peak_hold_triggers(
            region,
            threshold,
            constant.hysteresis,
            state.peak_hold_state,
            state.peak_holding,
            valid=idx >= (chunk - ns),
        )
        age = (chunk - 1.0) - idx  # age relative to the history end
        cand = jnp.where(fires, age, _FIRE_AGE_NONE)  # [pairs, chunk]
        k_new = min(PEAK_QUEUE_SIZE, chunk)
        newest = -jax.lax.top_k(-cand, k_new)[0]
        carried = jnp.minimum(
            state.peak_fire_ages + new_samples, _FIRE_AGE_NONE
        )
        merged = jnp.concatenate([newest, carried], axis=-1)
        new_fire_ages = -jax.lax.top_k(-merged, PEAK_QUEUE_SIZE)[0]
        # newest fire with its half window complete, still inside history
        mature = (new_fire_ages >= window * 0.5 - 1.0) & (new_fire_ages < hf)
        age_sel = jnp.min(
            jnp.where(mature, new_fire_ages, _FIRE_AGE_NONE), axis=-1
        )
        found = age_sel < _FIRE_AGE_NONE
        trigger_pos = hf - 1.0 - jnp.where(found, age_sel, 0.0)
        start = trigger_pos - (window - 1.0) * 0.5
        start = jnp.clip(start, 0.0, hf - window)
        start = jnp.where(found, start, hf - window)
    elif trigger_mode == TriggerMode.SPECTRAL:
        la = min(constant.lookahead, h)
        region = trig_src[..., h - la :]
        if constant.custom_trigger:
            # user frequency short-circuits the fundamental search
            # (ref: OscilloscopeDSP.inl:69-78 — BinRecord{0, 1, f/fs * N};
            # the full omega lands in the offset field, whose tau-multiple
            # phase correction is mod-tau equivalent to its fraction)
            omega = constant.custom_trigger_frequency / sample_rate * la
            record = BinRecord(
                index=jnp.zeros((pairs,), jnp.int32),
                value=jnp.ones((pairs,), jnp.float32),
                offset=jnp.broadcast_to(omega, (pairs,)).astype(jnp.float32),
            )
            fundamental = jnp.broadcast_to(
                constant.custom_trigger_frequency, (pairs,)
            ).astype(jnp.float32)
            cycles = sample_rate / fundamental
        else:
            fundamental, cycles, record = spectral_fundamental(
                region, sample_rate, threshold=threshold, hysteresis=constant.hysteresis
            )
            new_median, record, _ = median_record_filter(state.median_history, record)
            fundamental = sample_rate * jnp.maximum(record.omega(), 5.0 * la / sample_rate) / la
            cycles = sample_rate / fundamental
        sample_offset = trigger_phase_offset(
            region,
            record.omega(),
            cycles,
            window,
            sample_rate,
            fundamental,
            record.offset,
            constant.phase_degrees,
        )
        # anchor one cycle before the window end, then advance by the
        # phase-derived offset so x=0 lands on a fixed waveform phase
        # (ref: bufferOffset = roundedWindow + quantizedCycleSamples and the
        # -sampleOffset x-shift, OscilloscopeRendering.cpp:604-613)
        start = hf - window - cycles + sample_offset
        start = jnp.clip(start, 0.0, hf - window)
    elif trigger_mode == TriggerMode.WINDOW:
        # window-synced scroll (ref: OscilloscopeRendering.cpp:587-592)
        real_offset = jnp.mod(transport_position, window)
        start = jnp.clip(hf - window - real_offset, 0.0, hf - window)
        start = jnp.broadcast_to(start, (pairs,))
    else:
        start = jnp.broadcast_to(hf - window, (pairs,))

    start = jnp.broadcast_to(start, (pairs,))
    step = (window - 1.0) / max(pixels - 1, 1)
    step = jnp.broadcast_to(step, (pairs,))

    # --- resample rows to pixel space --------------------------------------
    start_r = start[:, None]
    step_r = step[:, None]
    if constant.interpolation == SubSampleInterpolation.LANCZOS:
        wave = sinc_resample(rows, start_r, step_r, pixels, INTERPOLATION_KERNEL_SIZE)
    elif constant.interpolation == SubSampleInterpolation.LINEAR:
        wave = linear_resample(rows, start_r, step_r, pixels)
    else:  # NONE / RECTANGULAR: nearest sample
        wave = nearest_resample(rows, start_r, step_r, pixels)

    # min-max envelope over the DISPLAYED window [start, start+window)
    # — a render-feed addition (the reference draws every sample as a GL
    # primitive instead); decimating the whole history instead would
    # misalign the band from the drawn trace whenever window < history.
    # Formulation: nearest-sample at OS points per pixel, reduced per
    # pixel — nearest at spacing <= 1 hits every source sample in the
    # span, so with OS >= h/pixels >= max step this is the exact min/max.
    # Static per-pixel oversampling >= the actual step (see env_os doc):
    # the fence-post bound ceil((h-1)/(pixels-1)) dominates the max
    # possible step (window-1)/(pixels-1) for every window <= h (plain
    # ceil(h/pixels) does NOT when pixels divides h: 4095/255 > 4096/256).
    os_ = env_os if env_os is not None else max(1, -(-(h - 1) // max(pixels - 1, 1)))
    dense = nearest_resample(rows, start_r, step_r / os_, pixels * os_)
    dense = dense.reshape(dense.shape[:-1] + (pixels, os_))
    env_min = jnp.min(dense, axis=-1)
    env_max = jnp.max(dense, axis=-1)

    # --- autogain (ref: analyseAndSetupState, OscilloscopeDSP.inl:44-59) ---
    new_peak_env, gain = _autogain_update(constant, state.peak_env, rows, new_samples)
    wave = wave * gain[:, None, None]

    # per-row key colours (ref: primaryColour/secondaryColour,
    # OscilloscopeParameters.h; ChannelData.h:58-66 aux colour buffers),
    # hue-rotated per pair when pair_keys is supplied
    if pair_keys is None:
        key = constant.key_colours[: rows.shape[1]]  # [rows, 3]
    else:
        key = pair_keys[:, : rows.shape[1], :]  # [pairs, rows, 3]

    # --- colouring ----------------------------------------------------------
    if constant.colour_enabled:
        bands, new_xover = three_band_split(rows, sample_rate, state=state.crossover)
        colours, new_smooth = spectral_colour_track(
            bands,
            constant.colour_pole,
            constant.band_colours,
            key,
            constant.colour_blend,
            state.colour_smooth,
        )  # [pairs, rows, H, 3]
        # resample colour track to pixels (nearest); fold the rgb
        # channels into the row axis so the resampler sees
        # [pairs, rows*3, H].
        nrows = colours.shape[1]
        cflat = jnp.moveaxis(colours, -1, 2).reshape(pairs, nrows * 3, h)
        pix = nearest_resample(cflat, start_r, step_r, pixels)
        pix_colours = jnp.moveaxis(pix.reshape(pairs, nrows, 3, pixels), 2, 3)
    else:
        new_xover = state.crossover
        new_smooth = state.colour_smooth
        flat_key = key[None, :, None, :] if key.ndim == 2 else key[:, :, None, :]
        pix_colours = jnp.broadcast_to(flat_key, (pairs, rows.shape[1], pixels, 3))

    frame = OscilloscopeFrame(
        waveform=wave,
        envelope_min=env_min * gain[:, None, None],
        envelope_max=env_max * gain[:, None, None],
        colours=pix_colours,
        gain=gain,
        fundamental=fundamental,
        trigger_found=found,
    )
    new_state = OscilloscopeState(
        peak_env=new_peak_env,
        peak_hold_state=new_ph_state,
        peak_holding=new_holding,
        median_history=new_median,
        crossover=new_xover,
        colour_smooth=new_smooth,
        peak_fire_ages=new_fire_ages,
    )
    return frame, new_state


_osc_step = jax.jit(
    osc_step_impl, donate_argnums=(1,), static_argnames=("trigger_chunk", "env_os")
)


@jax.jit
def _cycle_feedback(fundamental, window_value, sample_rate):
    """Next Cycles-mode window from the detected fundamental, device-side
    (ref: Oscilloscope.cpp:299-303): cycleSamples = fs / f0,
    window = value * cycleSamples + 1. The reference updates
    unconditionally — cycleSamples simply persists between spectral
    runs, and the spectral path floors the fundamental at 5 Hz so an
    "undetected" f0 <= 0 cannot occur (a round-3 review killed the dead
    keep-previous branch here). The 128-sample floor is a deliberate
    deviation guarding degenerate windows."""
    f0 = fundamental[0]
    cycles = sample_rate / jnp.maximum(f0, 1e-9)
    window = jnp.maximum(128.0, window_value * jnp.maximum(cycles, 1.0) + 1.0)
    return window.astype(jnp.float32), cycles.astype(jnp.float32)
