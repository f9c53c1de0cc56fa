"""VectorscopeProcessor — stateful public face of the vectorscope view.

Plays the role of the reference's ``VectorScope::Processor`` + rendering
vertex generation (ref: Source/Vectorscope/Vectorscope.cpp:268-377,
VectorscopeRendering.cpp). Owns the meter filter states and auto-gain,
emits render-ready vertex arrays ([N, 3] point clouds) and meter readouts.
"""

from __future__ import annotations

import enum
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from signalizer_tpu.kernels.vectorscope import (
    VectorscopeMeterState,
    filter_coefficient,
    init_meter_state,
    lissajous_vertices,
    meter_readout,
    peak_autogain_update,
    polar_vertices,
    rms_autogain,
    update_meters,
)


class OperationalMode(enum.IntEnum):
    """ref: VectorscopeParameters.h operationalMode."""

    LISSAJOUS = 0
    POLAR = 1


class AutoGain(enum.IntEnum):
    """ref: VectorscopeParameters.h autoGain {None, RMS, PeakDecay}."""

    NONE = 0
    RMS = 1
    PEAK_DECAY = 2


class VectorscopeFrame(NamedTuple):
    vertices: jax.Array  # [..., W, 3] point cloud (x, y, age-fade z)
    balance: jax.Array  # [..., 2] quick/slow balance bars in [0, 1]
    correlation_bars: jax.Array  # [..., 2] quick/slow correlation bars in [0, 1]
    gain: jax.Array  # [...] applied gain


def vs_step_impl(
    state: VectorscopeMeterState,
    peak_env: jax.Array,
    frames: jax.Array,
    envelope_pole: jax.Array,
    stereo_pole: jax.Array,
    user_gain: jax.Array,
    peak_coeff: jax.Array,
    rotation: jax.Array = 0.0,
    new_samples: jax.Array = None,
    meter_frames: jax.Array = None,
    *,
    mode: OperationalMode,
    autogain: AutoGain,
    scale_to_fill: bool,
):
    # new_samples: trailing-samples meter mask for overlapping-window
    # callers (see kernels/vectorscope.update_meters); the vertex/display
    # path always renders the full window. meter_frames: optionally a
    # SHORTER trailing slice covering (at least) the new samples — the
    # meters only integrate those, and the masked full-window form wastes
    # window/new_samples x the transcendental work (pow/atan/cos per
    # sample); the session passes the pow2 bucket of the tick's new
    # samples. None = integrate over ``frames`` (non-overlapping feeds).
    new_state = update_meters(
        state, frames if meter_frames is None else meter_frames,
        envelope_pole=envelope_pole, stereo_pole=stereo_pole,
        new_samples=new_samples,
    )
    # degenerate autogain readings HOLD the carried last-normal gain
    # instead of popping to unity (the reference's isnormal() guard,
    # Vectorscope.cpp:362-366 / VectorscopeRendering.cpp:884-888)
    if autogain == AutoGain.RMS:
        g = rms_autogain(new_state, fallback=state.gain)
        new_state = new_state._replace(gain=g)
        gain = g * user_gain
        new_peak_env = peak_env
    elif autogain == AutoGain.PEAK_DECAY:
        new_peak_env, g = peak_autogain_update(
            peak_env, frames, peak_coeff, fallback=state.gain
        )
        new_state = new_state._replace(gain=g)
        gain = g * user_gain
    else:
        gain = jnp.broadcast_to(user_gain, frames.shape[:-2])
        new_peak_env = peak_env
    gain_b = gain[..., None]  # broadcast over the sample axis
    if mode == OperationalMode.POLAR:
        verts = polar_vertices(frames, gain=gain_b, scale_to_fill=scale_to_fill)
    else:
        verts = lissajous_vertices(frames, rotation=rotation, gain=gain_b)
    bars = meter_readout(new_state)
    return VectorscopeFrame(verts, bars["balance"], bars["correlation"], gain), new_state, new_peak_env


_vs_step = functools.partial(
    jax.jit, static_argnames=("mode", "autogain", "scale_to_fill")
)(vs_step_impl)


class VectorscopeProcessor:
    """Stateful wrapper over the vectorscope kernels.

    ``process(frames)`` with frames [pairs, 2, W] returns a
    :class:`VectorscopeFrame`; filter states carry across calls.
    """

    def __init__(
        self,
        *,
        pairs: int = 1,
        sample_rate: float = 48_000.0,
        mode: OperationalMode = OperationalMode.LISSAJOUS,
        autogain: AutoGain = AutoGain.NONE,
        envelope_window: float = 0.1,  # normalized (ref: envelopeWindow param)
        stereo_window: float = 0.02,
        rotation: float = 0.0,  # turns (ref: waveZRotation)
        user_gain: float = 1.0,
        frame_rate: float = 60.0,
        scale_to_fill: bool = False,
    ):
        self.pairs = pairs
        self.sample_rate = sample_rate
        self.mode = OperationalMode(mode)
        self.autogain = AutoGain(autogain)
        self.rotation = float(rotation)
        self.user_gain = float(user_gain)
        self.scale_to_fill = bool(scale_to_fill)
        self.frame_rate = frame_rate
        self.envelope_pole = filter_coefficient(envelope_window, sample_rate)
        self.stereo_pole = filter_coefficient(stereo_window, sample_rate)
        self._state = init_meter_state((pairs,))
        self._peak_env = jnp.zeros((pairs, 2), jnp.float32)
        # per-window-size scalar args cached on device: saves an eager
        # upload per scalar per call
        self._scalar_cache: dict = {}

    @property
    def state(self) -> VectorscopeMeterState:
        return self._state

    def reset(self) -> None:
        self._state = init_meter_state((self.pairs,))
        self._peak_env = jnp.zeros((self.pairs, 2), jnp.float32)

    def process(self, frames, new_samples=None, meter_frames=None) -> VectorscopeFrame:
        """``new_samples``: when re-reading an overlapping history window
        per tick, the count of samples that are NEW since the last call —
        the meter filters consume each sample exactly once (the
        reference's audio-callback cadence, Vectorscope.cpp:319-342);
        None keeps the whole-window semantics for non-overlapping feeds.
        ``meter_frames``: optional shorter trailing slice for the meter
        update (see :func:`vs_step_impl`)."""
        if not isinstance(frames, jax.Array):
            frames = jnp.asarray(frames, jnp.float32)
        meter_w = frames.shape[-1] if meter_frames is None else meter_frames.shape[-1]
        scalars, new_samples = self._prep_step(
            frames.shape[-1], new_samples, meter_w=meter_w
        )
        frame, self._state, self._peak_env = _vs_step(
            self._state,
            self._peak_env,
            frames,
            *scalars,
            new_samples,
            meter_frames,
            mode=self.mode,
            autogain=self.autogain,
            scale_to_fill=self.scale_to_fill,
        )
        return frame

    def _prep_step(self, w: int, new_samples, meter_w: int = None):
        """Host-side scalar prep shared by :meth:`process` and the
        session's fused all-views tick (one source of truth so the two
        paths dispatch identical scalars and stay bit-equal).
        ``meter_w``: width of the meter slice the new-samples count must
        clamp to (defaults to the display window width)."""
        key = (w, self.envelope_pole, self.stereo_pole, self.user_gain, self.rotation)
        scalars = self._scalar_cache.get(key)
        if scalars is None:
            if len(self._scalar_cache) > 64:
                self._scalar_cache.clear()
            # peak autogain decay scaled per visible buffer per frame
            # (ref: VectorscopeRendering.cpp:839-842) — host math, then one
            # upload, cached. rotation rides as a TRACED scalar: a
            # draggable knob in the jit compile key would recompile per
            # distinct value
            scalars = (
                jnp.asarray(self.envelope_pole, jnp.float32),
                jnp.asarray(self.stereo_pole, jnp.float32),
                jnp.asarray(self.user_gain, jnp.float32),
                jnp.asarray(self.envelope_pole ** (w / self.frame_rate), jnp.float32),
                jnp.asarray(self.rotation, jnp.float32),
            )
            self._scalar_cache[key] = scalars
        if new_samples is not None:
            # cache the device scalar: a steady hop re-sends the same
            # value every render tick, one avoidable upload per tick
            # (the oscilloscope's _dev_scalar pattern)
            ns = min(float(new_samples), float(w if meter_w is None else meter_w))
            new_samples = self._scalar_cache.get(("ns", ns))
            if new_samples is None:
                new_samples = jnp.float32(ns)
                self._scalar_cache[("ns", ns)] = new_samples
        return scalars, new_samples
