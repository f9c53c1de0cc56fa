"""Peak-decay filtering as an associative scan.

The reference's per-pixel peak filter (ref: cpl CPeakFilter usage at
Source/Spectrum/TransformDSP.inl:1336-1341) is the recurrence

    state[t] = max(pole * state[t-1], x[t])

— sequential in time, parallel across pixels/graphs/streams. On the accelerator we
exploit that this is a max-plus linear recurrence: with elements
``(p, v)`` and the associative combine ``(p1,v1) o (p2,v2) =
(p1*p2, max(v1*p2, v2))`` the whole T-frame history evaluates in
O(log T) depth via ``jax.lax.associative_scan`` (design noted in
SURVEY.md §5.8). All quantities are non-negative so the linear-domain
form is numerically safe (pole^T underflow decays to 0, the true limit).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def peak_decay_step(state: jax.Array, x: jax.Array, pole) -> jax.Array:
    """One frame: ``max(pole * state, x)``."""
    return jnp.maximum(pole * state, x)


def _combine(a, b):
    pa, va = a
    pb, vb = b
    return pa * pb, jnp.maximum(va * pb, vb)


def peak_decay_scan(
    state0: jax.Array, xs: jax.Array, pole, *, time_axis: int = None, valid=None
) -> Tuple[jax.Array, jax.Array]:
    """Run the decay recurrence over a time-sequence of frames.

    Args:
      state0: initial state, shape ``S``.
      xs: new values, shape ``S`` with one extra time axis inserted; by
        default the time axis is ``xs.ndim - state0.ndim - 1 + ...`` — i.e.
        ``xs = [..., T, *suffix]`` aligned so that ``xs.shape`` minus the
        time axis equals ``state0.shape``. Pass ``time_axis`` explicitly
        when ambiguous.
      pole: decay coefficient(s), broadcastable against ``state0``.
      valid: optional [T] bool along the time axis; ``False`` frames are
        identity steps (state passes through unchanged — host-side padding
        for bucketed batch shapes). Requires non-negative ``xs`` (true for
        every magnitude path; the identity element under max-decay is
        ``(pole=1, x=0)``).

    Returns ``(decayed, final_state)`` where ``decayed`` has ``xs``'s shape
    and holds the post-update state per frame (the reference computes each
    frame's display value from the updated state).
    """
    if time_axis is None:
        if xs.ndim != state0.ndim + 1:
            raise ValueError("xs must have exactly one more axis than state0")
        time_axis = 0
    time_axis = time_axis % xs.ndim

    t = jnp.moveaxis(xs, time_axis, 0)  # [T, *S'] where S' broadcasts to S
    T = t.shape[0]
    pole_b = jnp.broadcast_to(jnp.asarray(pole, t.dtype), state0.shape)

    if valid is not None:
        vt = jnp.asarray(valid).reshape((T,) + (1,) * (t.ndim - 1))
        t = jnp.where(vt, t, 0.0)

    if T == 1:
        if valid is not None:
            pole_b = jnp.where(valid[0], pole_b, 1.0)
        new = peak_decay_step(state0, t[0], pole_b)
        return jnp.expand_dims(new, time_axis), new

    # xs may use broadcast dims (e.g. a singleton line-graph axis against a
    # K-sized state axis) — expand to the full state shape for the scan
    full = jnp.broadcast_shapes(state0.shape, t.shape[1:])
    t = jnp.broadcast_to(t, (T,) + full)
    state_full = jnp.broadcast_to(state0, full)
    poles = jnp.broadcast_to(pole_b, t.shape)
    if valid is not None:
        vt = jnp.asarray(valid).reshape((T,) + (1,) * (len(full)))
        poles = jnp.where(vt, poles, 1.0)
    ones = jnp.ones_like(state_full)[None]
    elems = (
        jnp.concatenate([ones, poles], axis=0),
        jnp.concatenate([state_full[None], t], axis=0),
    )
    _, scanned = jax.lax.associative_scan(_combine, elems, axis=0)
    decayed = scanned[1:]  # drop the prepended initial state
    final = decayed[-1]
    return jnp.moveaxis(decayed, 0, time_axis), final
