"""On-device A/B: linear vs log-domain decay+dB at the headline geometry.

`kernels/spectrum._log_decay_db` re-derives the decay+dB stage in
max-plus algebra (one cummax'd array instead of a two-array mul+max
associative scan; log taken on the K-independent values; dB map affine).
This tool measures the FULL headline step with each path active, plus
the isolated stage, using the scan-slope regime (see bench._scan_rate).

Run on the GPU (one process on the card):

    python tools/decay_bench.py [--pairs 16] [--steps 128]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=16)
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--k1", type=int, default=8)
    ap.add_argument("--k2", type=int, default=64)
    args = ap.parse_args()

    import jax

    from signalizer_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from bench import _scan_rate
    from signalizer_tpu.core.config import (
        BinInterpolation,
        SpectrumChannels,
        ViewScaling,
    )
    from signalizer_tpu.core.constant import make_spectrum_constant
    import signalizer_tpu.kernels.spectrum as sp

    constant = make_spectrum_constant(
        axis_points=1024,
        window_size=4096,
        sample_rate=48_000.0,
        configuration=SpectrumChannels.SEPARATE,
        bin_interpolation=BinInterpolation.LINEAR,
        view_scaling=ViewScaling.LOGARITHMIC,
    )
    pairs, t_steps = args.pairs, args.steps
    rng = np.random.default_rng(0)
    frames = jnp.asarray(
        rng.standard_normal((pairs, t_steps, 2, 4096)).astype(np.float32)
    )
    state = sp.init_line_graph_state(constant, (pairs,))
    vals = jax.block_until_ready(sp.spectrum_values(constant, frames))

    out = {"pairs": pairs, "steps": t_steps, "device": str(jax.devices()[0])}
    t0 = time.perf_counter()

    def measure(name, body, carry):
        sec, meta = _scan_rate(body, carry, k1=args.k1, k2=args.k2)
        us = sec / (pairs * t_steps) * 1e6
        out[name] = round(us, 4)
        if meta.get("degraded"):
            out[f"{name}_degraded"] = True
        print(f"  {name}: {us:.3f} us/frame", file=sys.stderr)

    def full_body(c):
        st, x, acc = c
        r = sp.analyze_frames(constant, st, x)
        return r.state, jnp.roll(x, 1, axis=-1), acc + jnp.sum(r.results)

    def stage_body(c):
        st, v, acc = c
        r = sp.post_process(constant, st, v)
        return r.state, jnp.roll(v, 1, axis=-1), acc + jnp.sum(r.results)

    saved = sp._LOG_DECAY_MIN_T
    for name, thresh in (("linear", 10**9), ("log", 8)):
        sp._LOG_DECAY_MIN_T = thresh
        measure(f"full_{name}", full_body, (state, frames, jnp.float32(0.0)))
        measure(f"stage_{name}", stage_body, (state, vals, jnp.float32(0.0)))
    sp._LOG_DECAY_MIN_T = saved

    # parity on device for the record
    sp._LOG_DECAY_MIN_T = 10**9
    want = jax.jit(lambda s, f: sp.analyze_frames(constant, s, f))(state, frames)
    sp._LOG_DECAY_MIN_T = 8
    got = jax.jit(lambda s, f: sp.analyze_frames(constant, s, f))(state, frames)
    sp._LOG_DECAY_MIN_T = saved
    dr = float(jnp.max(jnp.abs(got.results - want.results)))
    ds = float(
        jnp.max(
            jnp.abs(got.state.magnitude - want.state.magnitude)
            / jnp.maximum(jnp.abs(want.state.magnitude), 1e-20)
        )
    )
    out["max_abs_results_diff"] = round(dr, 8)
    out["max_rel_state_diff"] = round(ds, 8)
    out["wall_s"] = round(time.perf_counter() - t0, 1)
    if out.get("full_linear") and out.get("full_log"):
        out["full_speedup"] = round(out["full_linear"] / out["full_log"], 3)
        out["stage_speedup"] = round(out["stage_linear"] / out["stage_log"], 3)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
