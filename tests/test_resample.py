"""Oscilloscope display resamples against per-tap numpy oracles.

The resamples are per-tap gathers on every backend; the oracle
(``oracle.resample_oracle``) evaluates the reference's tap loops
(OscilloscopeRendering.cpp:854-888, Lanczos kernel size 10 per
OscilloscopeParameters.h:47) in float64, independent of the kernel code.
A backend may evaluate the positions ``start + p * step`` with or without
a fused multiply-add; each result is held to the oracle at the
evaluation it fits (``oracle.display_positions``).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from oracle import display_positions, resample_oracle
from signalizer_tpu.kernels.oscilloscope import (
    INTERPOLATION_KERNEL_SIZE,
    linear_resample,
    nearest_resample,
    sinc_resample,
)

A = INTERPOLATION_KERNEL_SIZE
CLIP = {"lanczos": lambda w: (-(A + 1.0), w - 1.0 + A), "linear": lambda w: (-2.0, float(w)),
        "nearest": lambda w: (-1.0, float(w))}


def _run(kind, x, start, step, num_out):
    fn = {"lanczos": sinc_resample, "linear": linear_resample, "nearest": nearest_resample}[kind]
    return np.asarray(fn(jnp.asarray(x), jnp.asarray(start), jnp.asarray(step), num_out))


def _assert_matches_oracle(kind, got, x, start, step, num_out, rtol, atol):
    """got [B, R, P] against the oracle at start/step [B, 1], at the
    evaluation of the positions that fits it best."""
    lo, hi = CLIP[kind](x.shape[-1])
    wants = [resample_oracle(x, np.clip(display_positions(start, step, num_out, fused), lo, hi), kind)
             for fused in (False, True)]
    want = min(wants, key=lambda w: float(np.max(np.abs(got - w))))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


KINDS = ["lanczos", "linear", "nearest"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("step", [0.125, 0.37, 1.0, 2.5, 4.0])
def test_resample_matches_oracle_interior(kind, step):
    rng = np.random.default_rng(int(step * 1000))
    w, num_out = 2048, 192
    x = rng.standard_normal((2, 2, w)).astype(np.float32)
    # per-pair starts (the osc step's [pairs, 1] layout), shifted off the
    # sample grid so nearest never lands on an exact .5 tie
    start = np.asarray([[37.3], [900.61]], np.float32)
    stepv = np.full((2, 1), step, np.float32)
    got = _run(kind, x, start, stepv, num_out)
    assert got.shape == (2, 2, num_out)
    _assert_matches_oracle(kind, got, x, start, stepv, num_out, rtol=2e-4, atol=5e-5)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("edge", ["left", "right"])
def test_resample_matches_oracle_at_edges(kind, edge):
    """Positions hanging off the frame reproduce the oracle's tap clamp."""
    rng = np.random.default_rng(3)
    w, num_out, step = 512, 128, 0.4
    x = rng.standard_normal((1, 2, w)).astype(np.float32)
    s = -(A + 0.55) if edge == "left" else w - 1.0 - step * (num_out // 2) + 0.05
    start = np.full((1, 1), s, np.float32)
    stepv = np.full((1, 1), step, np.float32)
    got = _run(kind, x, start, stepv, num_out)
    _assert_matches_oracle(kind, got, x, start, stepv, num_out, rtol=2e-4, atol=5e-5)


@pytest.mark.parametrize(
    "kind,w,starts,step,rtol,atol",
    [
        # one start for three pairs, steps from deep zoom-in to zoom-out,
        # the left edge and the right edge
        ("lanczos", 2048, [0.0] * 3, 0.25, 2e-4, 5e-5),
        ("lanczos", 2048, [-3.0] * 3, 0.125, 2e-4, 5e-5),
        ("lanczos", 2048, [500.7] * 3, 1.0, 2e-4, 5e-5),
        ("lanczos", 2048, [2048 - 300.5] * 3, 1.8, 2e-4, 5e-5),
        # a start per pair, broadcast over the rows (the osc step's shape)
        ("lanczos", 2048, [10.0, 700.3, 1.5], 0.5, 2e-4, 5e-5),
        ("lanczos", 2048, [10.0, 700.3, 1.5], 4.0, 2e-4, 5e-5),
        ("linear", 1024, [33.37, 700.11], 0.251, 1e-5, 1e-5),
        ("nearest", 1024, [33.37, 700.11], 0.251, 1e-6, 0.0),
    ],
)
def test_resample_matches_oracle_per_pair_starts(kind, w, starts, step, rtol, atol):
    rng = np.random.default_rng(21 if kind == "lanczos" else 23)
    x = rng.standard_normal((len(starts), 2, w)).astype(np.float32)
    start = np.asarray(starts, np.float32)[:, None]
    stepv = np.full_like(start, step)
    got = _run(kind, x, start, stepv, 256)
    _assert_matches_oracle(kind, got, x, start, stepv, 256, rtol=rtol, atol=atol)


def test_nearest_ties_round_upward():
    x = np.arange(16, dtype=np.float32)[None, None]
    got = _run("nearest", x, np.zeros((1, 1), np.float32), np.full((1, 1), 0.5, np.float32), 8)
    # positions 0, .5, 1, 1.5, ... pick floor(pos + 0.5)
    np.testing.assert_array_equal(got[0, 0], [0, 1, 1, 2, 2, 3, 3, 4])
