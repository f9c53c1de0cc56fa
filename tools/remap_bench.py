"""A/B candidates for the display remap (interp + bin-max select).

The production remap (kernels/spectrum.py) is a weighted tap gather
(`_interp`) plus a scatter-based `jax.ops.segment_max` (`_binmax_mag`)
and a static select — the vectorized form of the reference's per-pixel
interpolate-vs-binmax walk (ref: TransformDSP.inl:562-639). This tool
A/Bs two XLA-level candidates that keep the same select semantics:

* ``matmul``: the tap interpolation as one dense [nv, P] matmul
  (weights scattered into a constant matrix at plan-build time; zero
  columns for bin-max pixels). Replaces the [.., P, taps] gather.
* ``banded``: the segment max as a constant-index banded gather — each
  bin-max pixel's chunk {oldBin+1..bin} is a CONTIGUOUS bin range, so a
  [P, maxband] gather + mask + max replaces the scatter.
* ``both``: both replacements together.

Exactness is asserted against the production path (same floats modulo
matmul accumulation order; tolerance 1e-6 relative) before anything is
timed. Timings are scan-slope with the input rotated per step.

Both candidates are ALSO wired into the production path behind
``SIGNALIZER_TPU_REMAP=banded|matmul|both`` (plan fields in
core/constant.py build_remap_plan/dense_interp_matrix, routing in
kernels/spectrum._remap_mag), so a measured winner is a default flip.
Production-path equivalence is pytest-locked
(tests/test_spectrum.py test_remap_candidates_match_production).

Run on the GPU:

    python tools/remap_bench.py [--axis 1024] [--window 4096] [--interp linear]

Prints one JSON line: per-variant microseconds per [rows] remap at the
headline row batch, plus the full-pipeline (window+FFT+remap) delta.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def build_dense_interp(plan_idx, plan_wts, interp_mask, nv):
    """[nv, P] dense interpolation matrix from the gather plan."""
    p, taps = plan_idx.shape
    w = np.zeros((nv, p), np.float32)
    for x in range(p):
        if not interp_mask[x]:
            continue
        for t in range(taps):
            w[plan_idx[x, t], x] += plan_wts[x, t]
    return w


def build_bands(segment_ids, nv, p):
    """Contiguous [lo, hi] ranges per bin-max pixel -> banded gather plan.

    Returns (band_idx [P, maxband] int32, band_mask [P, maxband] bool).
    Pixels owning no bins (interp or single) get an all-masked row.
    """
    lo = np.full(p, nv, np.int64)
    hi = np.full(p, -1, np.int64)
    for b, x in enumerate(segment_ids):
        if x < p:
            lo[x] = min(lo[x], b)
            hi[x] = max(hi[x], b)
    lens = np.where(hi >= 0, hi - lo + 1, 0)
    maxband = max(int(lens.max()), 1)
    j = np.arange(maxband)[None, :]
    band_idx = np.clip(np.where(hi >= 0, lo, 0)[:, None] + j, 0, nv - 1)
    band_mask = j < lens[:, None]
    # sanity: ranges really are contiguous (every owned bin covered once)
    covered = int(band_mask.sum())
    owned = int((segment_ids < p).sum())
    assert covered == owned, (covered, owned)
    return band_idx.astype(np.int32), band_mask


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--axis", type=int, default=1024)
    ap.add_argument("--window", type=int, default=4096)
    ap.add_argument("--interp", choices=("linear", "lanczos"), default="linear")
    ap.add_argument("--pairs", type=int, default=16)
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--cpu", action="store_true", help="exactness checks only")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from signalizer_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from bench import _scan_rate
    from signalizer_tpu.core.config import (
        BinInterpolation,
        SpectrumChannels,
        ViewScaling,
    )
    from signalizer_tpu.core.constant import host_view, make_spectrum_constant
    from signalizer_tpu.kernels import spectrum as sp

    constant = make_spectrum_constant(
        axis_points=args.axis,
        window_size=args.window,
        sample_rate=48_000.0,
        configuration=SpectrumChannels.SEPARATE,
        bin_interpolation=(
            BinInterpolation.LINEAR
            if args.interp == "linear"
            else BinInterpolation.LANCZOS
        ),
        view_scaling=ViewScaling.LOGARITHMIC,
    )
    nv = int(constant.n_spectrum_values)
    p = int(constant.axis_points)

    seg_ids = np.asarray(host_view(constant, "segment_ids"))
    interp_mask_h = np.asarray(host_view(constant, "interp_mask"))
    idx_h = np.asarray(host_view(constant, "interp_indices"))
    wts_h = np.asarray(host_view(constant, "interp_weights"))

    w_dense = jnp.asarray(build_dense_interp(idx_h, wts_h, interp_mask_h, nv))
    band_idx_h, band_mask_h = build_bands(seg_ids, nv, p)
    band_idx = jnp.asarray(band_idx_h)
    band_mask = jnp.asarray(band_mask_h)
    maxband = band_idx_h.shape[1]

    HIGH = jax.lax.Precision.HIGHEST

    def remap_prod(mags):
        return jnp.where(
            constant.interp_mask,
            jnp.abs(sp._interp(mags, constant)),
            sp._binmax_mag(mags, constant),
        )

    def interp_matmul(mags):
        return jnp.matmul(mags, w_dense, precision=HIGH)

    def binmax_banded(mags):
        g = mags[..., band_idx]  # [..., P, maxband]
        segmax = jnp.max(jnp.where(band_mask, g, -jnp.inf), axis=-1)
        single = mags[..., constant.single_bin]
        return jnp.where(constant.single_mask, single, segmax)

    def remap_matmul(mags):
        return jnp.where(
            constant.interp_mask,
            jnp.abs(interp_matmul(mags)),
            sp._binmax_mag(mags, constant),
        )

    def remap_banded(mags):
        return jnp.where(
            constant.interp_mask,
            jnp.abs(sp._interp(mags, constant)),
            binmax_banded(mags),
        )

    def remap_both(mags):
        return jnp.where(
            constant.interp_mask,
            jnp.abs(interp_matmul(mags)),
            binmax_banded(mags),
        )

    variants = {
        "prod": remap_prod,
        "matmul": remap_matmul,
        "banded": remap_banded,
        "both": remap_both,
    }

    # --- exactness (always, on whatever backend) -------------------------
    rng = np.random.default_rng(0)
    mags_h = np.abs(rng.standard_normal((4, 2, nv))).astype(np.float32)
    mags = jnp.asarray(mags_h)
    want = np.asarray(jax.jit(remap_prod)(mags))
    checks = {}
    for name, fn in variants.items():
        got = np.asarray(jax.jit(fn)(mags))
        rel = float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-20))
        checks[f"maxrel_{name}"] = rel
        assert rel < 1e-5, (name, rel)

    out = {
        "axis": p,
        "nv": nv,
        "interp": args.interp,
        "maxband": maxband,
        **{k: round(v, 9) for k, v in checks.items()},
    }

    if args.cpu:
        print(json.dumps(out))
        return

    # --- device timings ----------------------------------------------------
    pairs, t_steps = args.pairs, args.steps
    big = jnp.asarray(
        np.abs(rng.standard_normal((pairs, t_steps, 2, nv))).astype(np.float32)
    )
    t0 = time.perf_counter()
    for name, fn in variants.items():
        def body(c, fn=fn):
            x, acc = c
            return jnp.roll(x, 1, axis=-1), acc + jnp.sum(fn(x))

        us = (
            _scan_rate(body, (big, jnp.float32(0.0)), k1=8, k2=64)[0]
            / (pairs * t_steps)
            * 1e6
        )
        out[f"remap_us_{name}"] = round(us, 4)
        print(f"  {name}: {us:.3f} us/frame", file=sys.stderr)

    # full pipeline effect (window+FFT+mag+remap), prod vs best candidate
    frames = jnp.asarray(
        rng.standard_normal((pairs, t_steps, 2, args.window)).astype(np.float32)
    )

    def full(remap):
        def fn(f):
            rows = sp._pack_channels(constant, f)
            mags = jnp.abs(sp._half_spectrum(constant, rows))
            return jnp.sum(remap(mags) * constant.inv_size)

        return fn

    for name in ("prod", "both"):
        fn = full(variants[name])

        def body(c, fn=fn):
            x, acc = c
            return jnp.roll(x, 1, axis=-1), acc + fn(x)

        us = (
            _scan_rate(body, (frames, jnp.float32(0.0)), k1=8, k2=64)[0]
            / (pairs * t_steps)
            * 1e6
        )
        out[f"pipeline_us_{name}"] = round(us, 4)
        print(f"  pipeline {name}: {us:.3f} us/frame", file=sys.stderr)

    out["wall_s"] = round(time.perf_counter() - t0, 1)
    out["device"] = str(jax.devices()[0])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
