"""Spectrogram colour mapping and multi-pair blending.

Re-design of the reference's spectrogram colour path
(ref: Source/Spectrum/SpectrumDSP.cpp:110-206 blendAndDispatchSpectrums).
Differences by design:

* The per-pixel gradient-segment walk becomes a vectorized searchsorted
  over precomputed segment boundaries.
* The sequential per-pair blend ``acc += (1 - acc) * src``
  (GL_ONE_MINUS_SRC_COLOR accumulation) telescopes to the closed form
  ``1 - prod_i(1 - src_i)`` — one parallel product over the pair axis
  instead of an ordered loop (exactly equal, since the recurrence is
  symmetric in its inputs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

NUM_SPECTRUM_COLOURS = 5  # ref: SpectrumParameters.h:77


def normalize_ratios(ratios) -> np.ndarray:
    """Normalize gradient segment widths to sum to 1 (the reference's
    normalizedSpecRatios; first entry is the background stop at 0)."""
    r = np.asarray(ratios, np.float64)
    total = r[1:].sum()
    out = np.zeros(len(r))
    out[1:] = r[1:] / (total if total > 0 else 1.0)
    return out


def gradient_map(intensity: jax.Array, colours: jax.Array, ratios: jax.Array) -> jax.Array:
    """Map normalized intensities through a piecewise-linear colour gradient
    (ref: renderSf, SpectrumDSP.cpp:119-169).

    intensity [..., P] in display space (values < 0 map to colour 0 /
    background — callers typically feed the dB-mapped results where
    below-range pixels are negative); colours [..., 6, 3] gradient stops
    (stop 0 = background); ratios [6] normalized segment widths
    (ratios[0] ignored). Returns rgb [..., P, 3].
    """
    if colours.ndim != 2:
        raise ValueError("gradient_map takes one [stops, 3] table; vmap for batches")
    bounds = jnp.cumsum(ratios)  # [6]; bounds[0] == 0
    x = jnp.clip(intensity, 0.0, 1.0)
    # segment c such that bounds[c-1] < x <= bounds[c]
    seg = jnp.searchsorted(bounds, x, side="left")
    seg = jnp.clip(seg, 1, ratios.shape[0] - 1)
    # 6-entry table reads as one-hot dots: six compares + a tiny matmul
    # instead of T x P element gathers (chosen on the previous
    # accelerator; not re-measured on the GPU)
    k = jnp.arange(ratios.shape[0])
    hot_lo = (seg[..., None] - 1) == k  # [..., P, 6]
    hot_hi = seg[..., None] == k
    # HIGHEST: a reduced-precision product (bf16 or TF32) would round the
    # bounds to ~2e-3 abs, which (x-lo)/(hi-lo) amplifies to ~10% mix
    # error on narrow gradient segments — visible colour banding
    hp = jax.lax.Precision.HIGHEST
    lo = jnp.einsum("...k,k->...", hot_lo.astype(bounds.dtype), bounds, precision=hp)
    hi = jnp.einsum("...k,k->...", hot_hi.astype(bounds.dtype), bounds, precision=hp)
    mix = jnp.where(hi > lo, (x - lo) / jnp.maximum(hi - lo, 1e-20), 1.0)
    c_lo = jnp.einsum("...k,kc->...c", hot_lo.astype(colours.dtype), colours, precision=hp)
    c_hi = jnp.einsum("...k,kc->...c", hot_hi.astype(colours.dtype), colours, precision=hp)
    rgb = c_lo * (1.0 - mix[..., None]) + c_hi * mix[..., None]
    # full-scale pixels take the last stop exactly (ref: :157-160)
    rgb = jnp.where((x >= 0.999)[..., None], colours[-1], rgb)
    # negative intensities contribute NOTHING to the accumulation
    # (ref: SpectrumDSP.cpp:124-125 `if (intensity < 0) continue;` over a
    # zero-initialized buffer) — black, not the background stop, so a
    # silent pair never tints the multi-pair ONE_MINUS_SRC_COLOR blend
    rgb = jnp.where((intensity < 0)[..., None], 0.0, rgb)
    return rgb


def blend_pairs(rgb: jax.Array, axis: int = 0) -> jax.Array:
    """Accumulate per-pair colours with GL_ONE_MINUS_SRC_COLOR semantics
    (ref: SpectrumDSP.cpp:162-167): closed form 1 - prod(1 - src)."""
    return 1.0 - jnp.prod(1.0 - rgb, axis=axis)


def quantize_rgba8(rgb: jax.Array) -> jax.Array:
    """[..., 3] float -> [..., 4] uint8 with opaque alpha
    (ref: SpectrumDSP.cpp:191-198)."""
    q = (jnp.clip(rgb, 0.0, 1.0) * 255.0).astype(jnp.uint8)
    alpha = jnp.full(q.shape[:-1] + (1,), 255, jnp.uint8)
    return jnp.concatenate([q, alpha], axis=-1)


def spectrogram_columns(
    intensity: jax.Array, colours: jax.Array, ratios: jax.Array
) -> jax.Array:
    """Full column pipeline: intensities [pairs, T, P] + per-pair colour
    tables [pairs, 6, 3] -> RGBA8 columns [T, P, 4] (pairs blended)."""
    rgb = jax.vmap(lambda inten, cols: gradient_map(inten, cols, ratios))(
        intensity, colours
    )  # [pairs, T, P, 3]
    blended = blend_pairs(rgb, axis=0)  # [T, P, 3]
    return quantize_rgba8(blended)
