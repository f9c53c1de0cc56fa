"""Vectorscope kernels: Lissajous/polar transforms, correlation, meters.

Re-design of the reference's vectorscope DSP
(ref: Source/Vectorscope/Vectorscope.cpp:268-377 audioProcessing,
VectorscopeRendering.cpp:444-497 drawRectPlot, :500-746 drawPolarPlot,
:748-822 drawStereoMeters, :825-889 runPeakFilter). Differences by design:

* All per-sample SIMD loops become batched vector maps over
  ``[..., 2, samples]`` frames.
* The scalar one-pole IIR meter filters (envelope, dual-speed balance and
  phase smoothing) are *not* scanned per sample on device: for a one-pole
  filter over a fixed-length block, the final state is an affine function
  of the initial state and a weighted sum of the inputs —
  ``s' = p^W s0 + (1-p) * sum_i p^(W-1-i) u[i]`` — so a whole block
  collapses to one dot product with a precomputed power ramp (matmul-friendly,
  exact, no sequential dependency). The reference only ever *reads* the
  filter state once per block, so per-sample outputs are unobservable.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from signalizer_tpu.kernels.filters import onepole_block_update

SQRT_HALF = 0.7071067811865476  # sqrt(2)/2


class VectorscopeMeterState(NamedTuple):
    """Filter states (ref: Vectorscope.h FilterStates / filters member).

    Axis convention: speed 0 = quick (pole = stereo_pole), speed 1 = slow
    (pole = stereo_pole ** 0.25, ref: Vectorscope.cpp:281
    secondStereoFilterSpeed = 0.25)."""

    envelope: jax.Array  # [..., 2] smoothed L^2 / R^2
    balance: jax.Array  # [..., 2(speed), 2(ch)] smoothed L^2 / R^2
    phase: jax.Array  # [..., 2(speed)] smoothed correlation
    # [...] last NORMAL raw autogain: the reference only overwrites
    # envelopeGain when the fresh 1/max(sqrt(env)) isnormal()
    # (Vectorscope.cpp:362-366, VectorscopeRendering.cpp:884-888), so on
    # silence/reset the previous gain persists instead of popping to 1
    gain: jax.Array


def init_meter_state(batch_shape: Tuple[int, ...] = ()) -> VectorscopeMeterState:
    return VectorscopeMeterState(
        envelope=jnp.zeros(batch_shape + (2,), jnp.float32),
        balance=jnp.zeros(batch_shape + (2, 2), jnp.float32),
        phase=jnp.zeros(batch_shape + (2,), jnp.float32),
        gain=jnp.ones(batch_shape, jnp.float32),
    )


def filter_coefficient(window_normalized, sample_rate) -> float:
    """One-pole coefficient from the normalized window parameter
    (ref: Vectorscope.cpp:201-202: exp(-1 / (norm * fs))). Host-side scalar
    math — an eager jnp op here would cost a device dispatch per processor
    construction."""
    return math.exp(-1.0 / (window_normalized * sample_rate))


# ---------------------------------------------------------------------------
# per-sample transforms
# ---------------------------------------------------------------------------


def correlation(frames: jax.Array) -> jax.Array:
    """Per-sample stereo correlation in [-1, 1]
    (ref: Vectorscope.cpp:297-317).

    Rotates (L, R) by 135 degrees, takes the phase angle, and returns
    ``cos(2*angle)`` (continuous across the +-pi seam). Silent samples
    (L == R == 0) read 0 (the reference substitutes a pi/4 dummy angle).
    frames [..., 2, W] -> [..., W].
    """
    left = frames[..., 0, :]
    right = frames[..., 1, :]
    x = -SQRT_HALF * (left + right)
    y = SQRT_HALF * (right - left)
    both_zero = (x == 0) & (y == 0)
    angle = jnp.arctan(y / jnp.where(both_zero, 1.0, x))
    angle = jnp.where(both_zero, jnp.pi / 4, angle)
    return jnp.cos(2.0 * angle)


def lissajous_vertices(frames: jax.Array, *, rotation: float = 0.0, gain=1.0) -> jax.Array:
    """Lissajous point cloud: frames [..., 2, W] -> vertices [..., W, 3].

    x = right, y = left (ref: drawRectPlot addVertex(right, left, z),
    VectorscopeRendering.cpp:466), z ramps -1 (oldest) .. 0 (newest) for age
    fading. Rotation (turns) and gain are folded in (the reference applies
    them on the GL matrix stack, :448-452)."""
    w = frames.shape[-1]
    left = frames[..., 0, :]
    right = frames[..., 1, :]
    x, y = right, left
    # rotation may be a TRACED scalar (a draggable knob must not be a jit
    # compile key — each distinct value would recompile); with a python
    # 0.0 XLA constant-folds the identity
    th = 2.0 * jnp.pi * rotation
    c, s = jnp.cos(th), jnp.sin(th)
    x, y = c * x - s * y, s * x + c * y
    fade = jnp.linspace(-1.0, 0.0, w, dtype=frames.dtype)
    fade = jnp.broadcast_to(fade, x.shape)
    return jnp.stack([gain * x, gain * y, fade], axis=-1)


def polar_vertices(frames: jax.Array, *, gain=1.0, scale_to_fill: bool = False) -> jax.Array:
    """Polar ("half-moon") point cloud: frames [..., 2, W] -> [..., W, 3]
    (ref: drawPolarPlot, VectorscopeRendering.cpp:563-604).

    length = max(|L|, |R|) (unit square -> triangle hypotenuse), the stereo
    field is rotated to center on the Y axis, and the angle folds both half
    circles upward; (x, y) = (sin, cos)(angle) * length."""
    w = frames.shape[-1]
    left = frames[..., 0, :]
    right = frames[..., 1, :]
    length = jnp.maximum(jnp.abs(left), jnp.abs(right))
    vy = -SQRT_HALF * (left + right)
    vx = SQRT_HALF * (left - right)
    both_zero = (left == 0) & (right == 0)
    angle = jnp.arctan(vx / jnp.where(vy == 0, jnp.finfo(frames.dtype).tiny, vy))
    angle = jnp.where(both_zero, 0.0, angle)
    x = jnp.sin(angle) * length
    y = jnp.cos(angle) * length
    x = x * gain
    y = y * gain
    if scale_to_fill:
        # stretch the [0, 1] half-circle to fill [-1, 1] vertically
        # (ref: Conditional01To11HeightTransform / scalePolarModeToFill)
        y = y * 2.0 - 1.0
    fade = jnp.linspace(-1.0, 0.0, w, dtype=frames.dtype)
    fade = jnp.broadcast_to(fade, x.shape)
    return jnp.stack([x, y, fade], axis=-1)


# ---------------------------------------------------------------------------
# meter filters (block-closed-form one-pole updates)
# ---------------------------------------------------------------------------


# the closed-form block one-pole lives in kernels/filters.py
# (onepole_block_update) — one canonical implementation (a private
# duplicate here diverged from it by round 3; round-3 review)
_block_onepole = onepole_block_update


def update_meters(
    state: VectorscopeMeterState,
    frames: jax.Array,
    *,
    envelope_pole,
    stereo_pole,
    second_speed: float = 0.25,
    new_samples=None,
) -> VectorscopeMeterState:
    """Advance all meter filters over a frame block
    (ref: Vectorscope.cpp:319-342). frames [..., 2, W].

    The reference advances these in the audio callback — each sample seen
    exactly once. A caller re-reading an overlapping history window per
    render tick must pass ``new_samples`` (traced scalar) so only the
    trailing new samples integrate; otherwise the meter ballistics scale
    with tick rate x window size instead of audio time (review finding)."""
    envelope_pole = jnp.asarray(envelope_pole, frames.dtype)
    stereo_pole = jnp.asarray(stereo_pole, frames.dtype)
    sq = frames[..., :2, :] ** 2  # [..., 2, W]
    corr = correlation(frames)  # [..., W]

    poles2 = jnp.stack(
        [jnp.broadcast_to(stereo_pole, state.phase.shape[:-1]),
         jnp.broadcast_to(stereo_pole**second_speed, state.phase.shape[:-1])],
        axis=-1,
    )  # [..., 2]

    env = _block_onepole(
        state.envelope, sq, jnp.broadcast_to(envelope_pole, state.envelope.shape),
        new_samples,
    )
    balance = _block_onepole(
        state.balance, sq[..., None, :, :], poles2[..., :, None], new_samples
    )
    phase = _block_onepole(state.phase, corr[..., None, :], poles2, new_samples)
    return VectorscopeMeterState(
        envelope=env, balance=balance, phase=phase, gain=state.gain
    )


def meter_readout(state: VectorscopeMeterState):
    """Meter bar positions in [0, 1] (ref: drawStereoMeters,
    VectorscopeRendering.cpp:766-775): balance = atan(balR/balL)/(pi/2)
    (0.5 fallback when degenerate), correlation = phase * 0.5 + 0.5.

    Returns dict with 'balance' [..., 2(speed)] and 'correlation'
    [..., 2(speed)]."""
    bal_l = state.balance[..., 0]
    bal_r = state.balance[..., 1]
    # atan(R/L)/(pi/2); L == 0 with R > 0 is a hard-right +inf ratio -> 1.0
    # (the reference relies on IEEE atan(+inf) = pi/2); only 0/0 is
    # degenerate and falls back to center. An exactly-zero result also
    # snaps to center: the reference guards with !std::isnormal, and 0.0
    # is not a normal float — so a mathematically hard-left signal whose
    # R envelope reads EXACTLY 0 displays center (a real decaying
    # envelope is merely tiny, so live hard-left still reads ~0.0).
    raw = jnp.arctan(bal_r / jnp.where(bal_l == 0, 1.0, bal_l)) / (jnp.pi * 0.5)
    raw = jnp.where(raw == 0.0, 0.5, raw)
    balance = jnp.where(bal_l > 0, raw, jnp.where(bal_r > 0, 1.0, 0.5))
    corr_bar = state.phase * 0.5 + 0.5
    return {"balance": balance, "correlation": corr_bar}


# ---------------------------------------------------------------------------
# autogain
# ---------------------------------------------------------------------------


def rms_autogain(state: VectorscopeMeterState, fallback=None) -> jax.Array:
    """RMS auto-gain 1 / max(sqrt(envL), sqrt(envR))
    (ref: Vectorscope.cpp:347-366). When the fresh value is degenerate
    (zero/inf envelope) the reference's isnormal() guard KEEPS the
    previous envelopeGain — the default fallback is the state's carried
    last-normal gain; pass ``fallback`` to override."""
    if fallback is None:
        fallback = state.gain
    g = 1.0 / jnp.maximum(
        jnp.sqrt(state.envelope[..., 0]), jnp.sqrt(state.envelope[..., 1])
    )
    return jnp.where(jnp.isfinite(g) & (g > 0), g, fallback)


def peak_autogain_update(
    envelope: jax.Array, frames: jax.Array, decay_coeff, fallback=1.0
) -> Tuple[jax.Array, jax.Array]:
    """Peak-decay auto-gain over the visible buffer
    (ref: runPeakFilter, VectorscopeRendering.cpp:825-889):
    env[ch] = max(env * coeff, peak[ch]^2); gain = 1/max(sqrt(env)).

    envelope [..., 2]; frames [..., 2, W]. Returns (new_envelope, gain).
    ``fallback`` replaces a degenerate gain — pass the previous gain for
    the reference's isnormal() hold (VectorscopeRendering.cpp:884-888)."""
    peaks = jnp.max(jnp.abs(frames[..., :2, :]), axis=-1)  # [..., 2]
    new_env = jnp.maximum(envelope * decay_coeff, peaks**2)
    g = 1.0 / jnp.sqrt(jnp.maximum(new_env[..., 0], new_env[..., 1]))
    gain = jnp.where(jnp.isfinite(g) & (g > 0), g, fallback)
    return new_env, gain


def apply_transform(vertices: jax.Array, matrix, translation=None) -> jax.Array:
    """Apply a 3x3 transform (+ optional translation) to [..., N, 3] vertex
    clouds (ref: ParameterTransformValue / MatrixModification usage —
    the reference applies these on the GL matrix stack)."""
    m = jnp.asarray(matrix, vertices.dtype)
    out = jnp.einsum("ij,...nj->...ni", m, vertices, precision=jax.lax.Precision.HIGHEST)
    if translation is not None:
        out = out + jnp.asarray(translation, vertices.dtype)
    return out
