"""IIR filter kernels: biquads, Linkwitz-Riley crossovers, one-pole smoothers.

Accelerator replacements for cpl's DSP filter classes
(ref: cpl/dsp/LinkwitzRileyNetwork.h — 3-band crossover used for the
oscilloscope's spectral colouring, tuned at OscilloscopeDSP.inl:440;
cpl/dsp/SmoothedParameterState.h one-pole smoothers; the cpl submodule is
absent from the snapshot, so filter topologies are standard-text choices
documented here: RBJ-cookbook biquads, LR4 = squared 2nd-order Butterworth).

Sequential IIRs are re-expressed as **associative scans**: a biquad in
transposed direct form II is the 2-state linear recurrence
``s[n] = A s[n-1] + B x[n]`` and linear recurrences compose associatively
((M1,v1) o (M2,v2) = (M2 M1, M2 v1 + v2)), so a W-sample filter runs in
O(log W) depth on the VPU instead of W sequential steps.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class BiquadCoeffs(NamedTuple):
    """Normalized (a0 = 1) biquad coefficients."""

    b0: float
    b1: float
    b2: float
    a1: float
    a2: float


def butterworth_lowpass(fc: float, fs: float, q: float = math.sqrt(0.5)) -> BiquadCoeffs:
    """RBJ cookbook 2nd-order lowpass."""
    w0 = 2.0 * math.pi * fc / fs
    alpha = math.sin(w0) / (2.0 * q)
    cw = math.cos(w0)
    a0 = 1.0 + alpha
    return BiquadCoeffs(
        b0=(1.0 - cw) / 2.0 / a0,
        b1=(1.0 - cw) / a0,
        b2=(1.0 - cw) / 2.0 / a0,
        a1=-2.0 * cw / a0,
        a2=(1.0 - alpha) / a0,
    )


def butterworth_highpass(fc: float, fs: float, q: float = math.sqrt(0.5)) -> BiquadCoeffs:
    """RBJ cookbook 2nd-order highpass."""
    w0 = 2.0 * math.pi * fc / fs
    alpha = math.sin(w0) / (2.0 * q)
    cw = math.cos(w0)
    a0 = 1.0 + alpha
    return BiquadCoeffs(
        b0=(1.0 + cw) / 2.0 / a0,
        b1=-(1.0 + cw) / a0,
        b2=(1.0 + cw) / 2.0 / a0,
        a1=-2.0 * cw / a0,
        a2=(1.0 - alpha) / a0,
    )


def _recurrence_scan(A: jax.Array, bx: jax.Array, s0: jax.Array) -> jax.Array:
    """Solve s[n] = A s[n-1] + bx[n] for all n via associative scan.

    A: [2, 2] constant; bx: [W, ..., 2]; s0: [..., 2].
    Returns states s[0..W-1] with shape [W, ..., 2].
    """
    w = bx.shape[0]
    # fold the initial state into the first element, then scan pairs
    # (M, v) under (M1,v1) o (M2,v2) = (M2 M1, M2 v1 + v2)
    bx = bx.at[0].add(jnp.einsum("ij,...j->...i", A, s0, precision=jax.lax.Precision.HIGHEST))
    mats = jnp.broadcast_to(
        A.reshape((1,) * (bx.ndim - 1) + (2, 2)), (w,) + bx.shape[1:-1] + (2, 2)
    )

    def comb(a, b):
        m1, v1 = a
        m2, v2 = b
        # HIGHEST precision is load-bearing: a reduced-precision product
        # (bf16, or TF32 on the GPU) rounds the near-marginal companion
        # matrix (|pole| ~ 0.97 for a 300 Hz crossover at 48 kHz) past the
        # unit circle, so the scanned matrix powers explode to inf/NaN
        hi = jax.lax.Precision.HIGHEST
        return (
            jnp.einsum("w...ij,w...jk->w...ik", m2, m1, precision=hi),
            jnp.einsum("w...ij,w...j->w...i", m2, v1, precision=hi) + v2,
        )

    _, states = jax.lax.associative_scan(comb, (mats, bx), axis=0)
    return states


def biquad_filter(
    coeffs: BiquadCoeffs, x: jax.Array, zi: jax.Array = None
) -> Tuple[jax.Array, jax.Array]:
    """Apply a biquad along the last axis. x [..., W]; zi [..., 2] TDF2
    state. Returns (y [..., W], zf [..., 2])."""
    b0, b1, b2, a1, a2 = (float(c) for c in coeffs)
    A = jnp.asarray([[-a1, 1.0], [-a2, 0.0]], dtype=x.dtype)
    Bv = jnp.asarray([b1 - a1 * b0, b2 - a2 * b0], dtype=x.dtype)

    xt = jnp.moveaxis(x, -1, 0)  # [W, ...]
    bx = xt[..., None] * Bv  # [W, ..., 2]
    if zi is None:
        zi = jnp.zeros(x.shape[:-1] + (2,), dtype=x.dtype)
    states = _recurrence_scan(A, bx, zi)  # [W, ..., 2]
    s1_prev = jnp.concatenate([zi[None, ..., 0:1], states[:-1, ..., 0:1]], axis=0)[..., 0]
    y = s1_prev + b0 * xt
    return jnp.moveaxis(y, 0, -1), states[-1]


class CrossoverState(NamedTuple):
    """Per-section TDF2 states for the 3-band network: [..., sections, 2]."""

    z: jax.Array


def init_crossover_state(batch_shape: Tuple[int, ...] = (), dtype=jnp.float32) -> CrossoverState:
    return CrossoverState(z=jnp.zeros(batch_shape + (8, 2), dtype))


def three_band_split(
    x: jax.Array,
    fs: float,
    f_low: float = 300.0,
    f_high: float = 3000.0,
    state: CrossoverState = None,
) -> Tuple[jax.Array, CrossoverState]:
    """3-band Linkwitz-Riley split (ref: cpl LinkwitzRileyNetwork<T,3>,
    tuned via tuneCrossOver(300, 3000) at OscilloscopeDSP.inl:440).

    LR4 topology: each crossover is a squared Butterworth biquad (24 dB/oct,
    allpass-summing). x [..., W] -> bands [..., 3, W] (low, mid, high).
    """
    if state is None:
        state = init_crossover_state(x.shape[:-1], x.dtype)
    lp_lo = butterworth_lowpass(f_low, fs)
    hp_lo = butterworth_highpass(f_low, fs)
    lp_hi = butterworth_lowpass(f_high, fs)
    hp_hi = butterworth_highpass(f_high, fs)

    z = state.z
    low1, z0 = biquad_filter(lp_lo, x, z[..., 0, :])
    low, z1 = biquad_filter(lp_lo, low1, z[..., 1, :])
    rest1, z2 = biquad_filter(hp_lo, x, z[..., 2, :])
    rest, z3 = biquad_filter(hp_lo, rest1, z[..., 3, :])
    mid1, z4 = biquad_filter(lp_hi, rest, z[..., 4, :])
    mid, z5 = biquad_filter(lp_hi, mid1, z[..., 5, :])
    high1, z6 = biquad_filter(hp_hi, rest, z[..., 6, :])
    high, z7 = biquad_filter(hp_hi, high1, z[..., 7, :])

    bands = jnp.stack([low, mid, high], axis=-2)
    new_state = CrossoverState(z=jnp.stack([z0, z1, z2, z3, z4, z5, z6, z7], axis=-2))
    return bands, new_state


def onepole_block_update(state: jax.Array, u: jax.Array, pole, new_samples=None) -> jax.Array:
    """Final state of s' = u + p (s - u) over a length-W block, closed form
    (see kernels/vectorscope.py rationale). state [...], u [..., W].

    ``new_samples`` (traced scalar, 0..W) consumes only the TRAILING that
    many samples — identity for the rest. Exact: the suffix samples keep
    their pole^(W-1-k) weights (positions within the suffix are the same
    distances from the block end) and the state decay becomes pole^new.
    Lets an overlapping-window caller advance the filter over each sample
    exactly once (the reference's audio-callback semantics)."""
    w = u.shape[-1]
    i = jnp.arange(w, dtype=u.dtype)
    pole = jnp.asarray(pole, u.dtype)
    ramp = jnp.power(pole[..., None], (w - 1) - i)
    if new_samples is None:
        decay = jnp.power(pole, float(w))
        acc = jnp.sum(u * ramp, axis=-1)
    else:
        n = jnp.asarray(new_samples, u.dtype)
        decay = jnp.power(pole, n)
        acc = jnp.sum(jnp.where(i >= w - n, u * ramp, 0.0), axis=-1)
    return decay * state + acc * (1.0 - pole)


def onepole_smooth(x: jax.Array, pole, s0: jax.Array = None) -> jax.Array:
    """Per-sample one-pole smoother s[n] = x[n] + p (s[n-1] - x[n]) along
    the last axis, via associative scan. Returns the full sequence."""
    pole = jnp.asarray(pole, x.dtype)
    w = x.shape[-1]
    xt = jnp.moveaxis(x, -1, 0) * (1.0 - pole)
    if s0 is not None:
        xt = xt.at[0].add(pole * s0)
    poles = jnp.broadcast_to(pole, xt.shape)

    def comb(a, b):
        return a[0] * b[0], a[1] * b[0] + b[1]

    _, seq = jax.lax.associative_scan(comb, (poles, xt), axis=0)
    return jnp.moveaxis(seq, 0, -1)
