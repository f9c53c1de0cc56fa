"""Complex resonator bank — the Spectrum's RSNT algorithm.

Re-design of cpl's ``CComplexResonator`` (ref: usage at
Source/Spectrum/TransformConstant.h:44-45,120-123 remapResonator and
TransformDSP.inl:1213-1295 resonatingDispatch; the cpl submodule is absent,
so the filter design is re-derived here from the documented behavior: a
per-display-pixel tuned complex one-pole bank with *windowed readout*
restricted to finite-cosine-sum windows, ref: SpectrumController.cpp:136-169).

Theory: a complex one-pole ``z[n] = c z[n-1] + x[n]`` with
``c = r e^{j w}`` is a sliding exponentially-weighted DFT at frequency w.
A cosine-sum window ``w[n] = sum_k (-1)^k a_k cos(2 pi k n / N)`` in the
frequency domain is a comb of 2K+1 Diracs, so the *windowed* sliding DFT
is a fixed linear combination of 2K+1 resonators offset by the bin spacing
— which is why the reference restricts RSNT to "finite DFT windows".

Accelerator transformation: the reference advances the bank per sample with
SIMD (resonateReal<V>). Per *block*, the recurrence has the closed form

    z' = c^W z + sum_n c^(W-1-n) x[n]

so a whole W-sample block is ONE complex matrix product of the input
against a precomputed [P*V, W] pole-power ramp — one batched matmul
instead of a length-W sequential dependency. States stay exact (same recurrence, just
evaluated associatively).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from signalizer_tpu.core.windows import WindowType, window_coefficients


@dataclasses.dataclass(frozen=True)
class _HostPoles:
    """Hashable host-side mirror of the complex poles.

    Rides the ResonatorConstant as STATIC aux data, so it survives every
    pytree flatten/unflatten (tree_map, jit reconstruction, checkpoint
    restore) and ``make_block_plan`` keeps the complex128 design values.
    Content-hashed via the raw bytes (static fields must be
    hashable/comparable for the jit cache key)."""

    data: bytes
    shape: tuple

    def array(self) -> np.ndarray:
        return np.frombuffer(self.data, np.complex128).reshape(self.shape)

    @classmethod
    def of(cls, poles: np.ndarray) -> "_HostPoles":
        poles = np.ascontiguousarray(poles, np.complex128)
        return cls(data=poles.tobytes(), shape=poles.shape)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ResonatorConstant:
    """Immutable resonator bank configuration.

    ``vectors`` = 2K+1 resonators per pixel (window order K). Leaves:

    * poles [P, V, 2] float32 — r_k e^{j(w_k + m d_k)} as (re, im)
      pairs: complex values stay inside jit (every host/jit boundary
      carries real pairs); kernels reconstitute complex internally
    * combine [V] float32 — signed window combination coefficients
    * gain [P] float32 — per-pixel normalization so a full-scale sine at
      the pixel's frequency reads magnitude 1.0 (matching the FFT path's
      invSize convention, TransformDSP.inl:540)
    """

    num_pixels: int = dataclasses.field(metadata=dict(static=True))
    vectors: int = dataclasses.field(metadata=dict(static=True))
    poles: jax.Array
    combine: jax.Array
    gain: jax.Array
    # host mirror for block-plan precomputation (make_block_plan): the
    # complex128 design-time poles, more exact than the float32 leaf.
    # Static aux data -> survives pytree round-trips.
    host_poles: Optional[_HostPoles] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )


def make_resonator_constant(
    mapped_frequencies: np.ndarray,
    sample_rate: float,
    window_size: int,
    *,
    window_type: WindowType = WindowType.HANN,
    free_q: bool = False,
    min_cycles: int = 8,
    min_window: int = 8,
    dtype=jnp.float32,
) -> ResonatorConstant:
    """Design the bank (ref: Resonator mapSystemHz call,
    TransformConstant.h:120-123 — freeQ flag, the constant 8, windowSize).

    Per pixel k with frequency f_k:

    * effective window N_k = window_size (locked Q), or with ``free_q``
      N_k = clamp(min_cycles * fs / f_k, min_window, window_size) —
      constant-Q: every pixel integrates ``min_cycles`` cycles.
    * pole radius r_k = 1 - 2/N_k (exponential window with the same
      equivalent length), vector offsets d_k = 2 pi / N_k (the window's
      bin spacing).
    * gain calibrated analytically from the steady-state response of the
      combined bank to a unit complex exponential at f_k.
    """
    freqs = np.asarray(mapped_frequencies, np.float64)
    p = len(freqs)
    coeffs = np.asarray(window_coefficients(window_type), np.float64)
    k_order = len(coeffs) - 1
    v = 2 * k_order + 1
    offsets_m = np.arange(-k_order, k_order + 1)

    if free_q:
        n_k = np.clip(min_cycles * sample_rate / np.maximum(freqs, 1e-3), min_window, window_size)
    else:
        n_k = np.full(p, float(max(window_size, min_window)))

    r = 1.0 - 2.0 / n_k  # equivalent-length exponential window
    r = np.clip(r, 0.0, 0.999999)
    omega = 2.0 * np.pi * freqs / sample_rate
    delta = 2.0 * np.pi / n_k
    angles = omega[:, None] + offsets_m[None, :] * delta[:, None]
    poles = r[:, None] * np.exp(1j * angles)  # [P, V]

    # combination: cos(k t) = (e^{jkt} + e^{-jkt})/2 -> vector m = +-k gets
    # (-1)^k a_k / 2 (m != 0), center gets a_0
    comb = np.zeros(v)
    comb[k_order] = coeffs[0]
    for k in range(1, k_order + 1):
        comb[k_order + k] = ((-1.0) ** k) * coeffs[k] * 0.5
        comb[k_order - k] = ((-1.0) ** k) * coeffs[k] * 0.5

    # steady-state response of the combined bank to e^{j omega n}:
    # each vector resonator accumulates 1/(1 - c_m e^{-j omega})
    resp = np.zeros(p, np.complex128)
    for m in range(v):
        resp += comb[m] / (1.0 - poles[:, m] * np.exp(-1j * omega))
    # a real sine contributes half its amplitude at +omega
    gain = 1.0 / np.maximum(np.abs(resp) * 0.5, 1e-20)

    return ResonatorConstant(
        num_pixels=p,
        vectors=v,
        poles=jnp.asarray(
            np.stack([poles.real, poles.imag], axis=-1), dtype
        ),
        combine=jnp.asarray(comb, jnp.float32),
        gain=jnp.asarray(gain, jnp.float32),
        host_poles=_HostPoles.of(poles),
    )


def init_resonator_state(
    constant: ResonatorConstant, batch_shape: Tuple[int, ...] = ()
) -> jax.Array:
    """Real (re, im) state pairs [..., P, V, 2] — see ResonatorConstant on
    why complex never crosses the jit boundary."""
    return jnp.zeros(batch_shape + (constant.num_pixels, constant.vectors, 2), jnp.float32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ResonatorBlockPlan:
    """Precomputed pole-power ramp for a fixed block length W.

    ``resonate_block``'s closed form needs ``c^(W-1-n)`` for every pole —
    ~P*V*W complex powers. They depend only on (bank, W), so recomputing
    them inside every dispatch wastes both device FLOPs and (without a
    surrounding scan for XLA to hoist them out of) most of the step time.
    Design once on the host, ship as constants.
    """

    block: int = dataclasses.field(metadata=dict(static=True))
    ramp: jax.Array  # [P, V, W, 2] (re, im) = c^(W-1-n)
    decay: jax.Array  # [P, V, 2] (re, im) = c^W


def make_block_plan(constant: ResonatorConstant, block: int) -> ResonatorBlockPlan:
    """Host-side plan precomputation from the design-time host mirror of
    the poles (static aux data, so it survives pytree round-trips).

    For constants without a mirror (hand-built, or restored by an old
    serializer), the poles are read back from the constant's own leaf,
    on whatever device it lives."""
    if constant.host_poles is not None:
        poles = constant.host_poles.array()
    else:
        pv = np.asarray(jax.device_get(constant.poles), np.float64)
        poles = pv[..., 0] + 1j * pv[..., 1]
    n = np.arange(block)
    ramp = poles[..., None] ** (block - 1 - n)  # [P, V, W] complex128
    decay = poles**block
    return ResonatorBlockPlan(
        block=int(block),
        ramp=jnp.asarray(np.stack([ramp.real, ramp.imag], axis=-1), jnp.float32),
        decay=jnp.asarray(np.stack([decay.real, decay.imag], axis=-1), jnp.float32),
    )


def _poles_c(constant: ResonatorConstant) -> jax.Array:
    return jax.lax.complex(constant.poles[..., 0], constant.poles[..., 1])


def _to_c(state: jax.Array) -> jax.Array:
    return jax.lax.complex(state[..., 0], state[..., 1])


def _to_pairs(z: jax.Array) -> jax.Array:
    return jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1)


def resonate_block(
    constant: ResonatorConstant,
    state: jax.Array,
    x: jax.Array,
    plan: ResonatorBlockPlan = None,
) -> jax.Array:
    """Advance the bank over a block: state [..., P, V, 2], x [..., W] real.

    Closed form (see module docstring): one [P*V, W] x [W] complex product
    per batch element — batched, this is one matmul. The input x is
    real, so the drive is computed as two REAL matmuls (re/im ramps) —
    no complex values at the jit boundary.

    ``plan``: precomputed ramp (:func:`make_block_plan`). Without it the
    ramp is recomputed in-graph — correct, but ~P*V*W transcendental ops
    that dominate a single-block dispatch.
    """
    w = x.shape[-1]
    if plan is not None:
        if plan.block != w:
            raise ValueError(f"plan is for block {plan.block}, got {w}")
        ramp_re, ramp_im = plan.ramp[..., 0], plan.ramp[..., 1]
        decay = jax.lax.complex(plan.decay[..., 0], plan.decay[..., 1])
    else:
        n = jnp.arange(w, dtype=jnp.float32)
        # c^(W-1-n) ramp: [P, V, W] complex, internal only
        ramp = _poles_c(constant)[..., None] ** (w - 1 - n)
        ramp_re, ramp_im = jnp.real(ramp), jnp.imag(ramp)
        decay = _poles_c(constant) ** float(w)
    hi = jax.lax.Precision.HIGHEST
    driven_re = jnp.einsum("pvw,...w->...pv", ramp_re, x, precision=hi)
    driven_im = jnp.einsum("pvw,...w->...pv", ramp_im, x, precision=hi)
    z = _to_c(state) * decay + jax.lax.complex(driven_re, driven_im)
    return _to_pairs(z)


def resonate_chunks(
    constant: ResonatorConstant,
    state: jax.Array,
    chunks: jax.Array,
    valid: jax.Array = None,
    plan: ResonatorBlockPlan = None,
    emit_readouts: bool = False,
):
    """Advance the bank over T time-ordered chunks in ONE traced scan.

    The production streaming path (ref: continuous resonate over blob
    chunks, TransformDSP.inl:1163-1211): a render tick consumes every
    pending chunk in a single dispatch instead of one dispatch per chunk.

    Args:
      chunks: [..., T, W] — T sequential blocks per batch element.
      valid: optional [T] bool; False chunks leave the state untouched
        (host-side padding to a bucketed T keeps the jit shape set small).
      plan: precomputed ramp for W (strongly recommended: inside the scan
        XLA hoists a recomputed ramp, but the plan also skips the
        first-dispatch transcendental burst).
      emit_readouts: also return the windowed magnitude readout after
        every chunk [T, ..., P] (the RSNT spectrogram semantic — one
        column per blob).

    Returns final state, or ``(final_state, readouts)``.
    """
    xs_t = jnp.moveaxis(chunks, -2, 0)  # [T, ..., W]

    def body(st, xs):
        if valid is None:
            new = resonate_block(constant, st, xs, plan)
        else:
            x, v = xs
            new = jnp.where(v, resonate_block(constant, st, x, plan), st)
        y = resonator_readout(constant, new) if emit_readouts else None
        return new, y

    xs = xs_t if valid is None else (xs_t, valid)
    final, ys = jax.lax.scan(body, state, xs)
    return (final, ys) if emit_readouts else final


def resonator_readout_complex(
    constant: ResonatorConstant, state: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Windowed COMPLEX readout (re, im) [..., P] — the vectors before
    |.| (ref: copyResonatorStateInto / getWholeWindowedState; the Phase
    branch of mapResonatingSystem consumes these,
    TransformDSP.inl:1111-1127). Normalized by the bank gain."""
    hi = jax.lax.Precision.HIGHEST
    z_re = jnp.einsum("...pv,v->...p", state[..., 0], constant.combine, precision=hi)
    z_im = jnp.einsum("...pv,v->...p", state[..., 1], constant.combine, precision=hi)
    return z_re * constant.gain, z_im * constant.gain


def resonator_readout(constant: ResonatorConstant, state: jax.Array) -> jax.Array:
    """Windowed magnitude readout (ref: getWholeWindowedState usage,
    TransformPair.h copyResonatorStateInto): combine the 2K+1 vectors with
    the window coefficients, normalize. state [..., P, V, 2] -> [..., P]."""
    z_re, z_im = resonator_readout_complex(constant, state)
    return jnp.sqrt(z_re * z_re + z_im * z_im)
