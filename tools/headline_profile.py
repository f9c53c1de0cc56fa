"""Stage-by-stage on-device cost of the headline spectrum pipeline.

Decomposes the BASELINE headline step (stereo 4096-pt SEPARATE spectrum,
window -> FFT -> |.| -> remap -> decay -> dB; ref pipeline:
Source/Spectrum/TransformDSP.inl:486-1135 + :1297-1435) into cumulative
prefixes, each measured as a scan-slope on the GPU (per-dispatch host
cost cancels in the slope; inputs rotate per step so XLA cannot hoist
loop-invariant work).

Prefix deltas = per-stage cost. Run on the GPU:

    python tools/headline_profile.py [--pairs 16] [--steps 128]

Prints one JSON line with microseconds per frame for each stage.
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
    from signalizer_tpu.kernels import spectrum as sp
    from signalizer_tpu.kernels.spectrum import (
        analyze_frames,
        init_line_graph_state,
    )

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
    state = init_line_graph_state(constant, (pairs,))

    # cumulative prefixes of the pipeline; each returns a scalar
    def p_window(f):
        return jnp.sum(sp._pack_channels(constant, f))

    def p_fft(f):
        rows = sp._pack_channels(constant, f)
        spec = sp._half_spectrum(constant, rows)
        return jnp.sum(jnp.real(spec)) + jnp.sum(jnp.imag(spec))

    def p_mag(f):
        rows = sp._pack_channels(constant, f)
        return jnp.sum(jnp.abs(sp._half_spectrum(constant, rows)))

    def p_interp(f):
        rows = sp._pack_channels(constant, f)
        mags = jnp.abs(sp._half_spectrum(constant, rows))
        return jnp.sum(jnp.abs(sp._interp(mags, constant)))

    def p_remap(f):
        return jnp.sum(sp.spectrum_values(constant, f))

    def p_full(f, st):
        r = analyze_frames(constant, st, f)
        return jnp.sum(r.results), r.state

    stages = {}

    def measure(name, body, carry):
        sec, meta = _scan_rate(body, carry, k1=args.k1, k2=args.k2)
        us = sec / (pairs * t_steps) * 1e6
        stages[name] = round(us, 4)
        if meta.get("degraded"):
            stages[f"{name}_degraded"] = True
        print(f"  {name}: {us:.3f} us/frame", file=sys.stderr)

    def simple_body(fn):
        def body(c):
            x, acc = c
            return jnp.roll(x, 1, axis=-1), acc + fn(x)

        return body

    t0 = time.perf_counter()
    measure("window", simple_body(p_window), (frames, jnp.float32(0.0)))
    measure("window_fft", simple_body(p_fft), (frames, jnp.float32(0.0)))
    measure("window_fft_mag", simple_body(p_mag), (frames, jnp.float32(0.0)))
    measure("window_fft_mag_interp", simple_body(p_interp), (frames, jnp.float32(0.0)))
    measure("spectrum_values", simple_body(p_remap), (frames, jnp.float32(0.0)))

    def full_body(c):
        st, x, acc = c
        s, nst = p_full(x, st)
        return nst, jnp.roll(x, 1, axis=-1), acc + s

    measure("full", full_body, (state, frames, jnp.float32(0.0)))

    deltas = {
        "d_window": stages["window"],
        "d_fft": round(stages["window_fft"] - stages["window"], 4),
        "d_mag": round(stages["window_fft_mag"] - stages["window_fft"], 4),
        "d_interp": round(
            stages["window_fft_mag_interp"] - stages["window_fft_mag"], 4
        ),
        "d_segmax_select": round(
            stages["spectrum_values"] - stages["window_fft_mag_interp"], 4
        ),
        "d_decay_db": round(stages["full"] - stages["spectrum_values"], 4),
    }
    out = {
        "pairs": pairs,
        "steps": t_steps,
        "device": str(jax.devices()[0]),
        "wall_s": round(time.perf_counter() - t0, 1),
        **stages,
        **deltas,
        "frames_per_sec_full": round(1e6 / stages["full"], 1),
    }

    # --- roofline: achieved FLOP/s and arithmetic intensity of the full
    # headline step vs the card's published ceilings (bench.DEVICE_PEAKS,
    # keyed by device_kind; an unknown card raises), from XLA's own cost
    # model on the compiled executable. The step is float32 outside the
    # tensor cores (cuFFT, elementwise, gathers), so the compute ceiling
    # is the f32 peak. The printed bound says which wall is nearer. The
    # peaks assume the card's rated power limit: the limit this run had is
    # printed beside the shares, and a lower one flags them as reading low.
    from bench import device_peaks, peak_share_note
    from signalizer_tpu.utils.device import query_nvidia_smi

    peaks = device_peaks(jax.devices()[0].device_kind)
    _, cards = query_nvidia_smi()
    note = peak_share_note(peaks, cards[0]["power_limit_w"] if cards else None)
    if note["shares_below_rated_power"]:
        print(f"headline_profile: power limit {note['power_limit_w']} W is below the "
              f"{note['peaks_rated_at_w']} W the peaks assume; the shares read low", file=sys.stderr)
    PEAK_F32 = peaks["f32_flops"]
    HBM_BPS = peaks["hbm_bytes_per_s"]
    try:
        compiled = (
            jax.jit(lambda st, f: p_full(f, st)).lower(state, frames).compile()
        )
        ca = compiled.cost_analysis()
        ca = ca[0] if isinstance(ca, (list, tuple)) else ca
        flops = float(ca.get("flops", 0.0))
        bytes_acc = float(ca.get("bytes accessed", 0.0))
        step_s = stages["full"] * pairs * t_steps * 1e-6
        achieved = flops / step_s if step_s else 0.0
        intensity = flops / bytes_acc if bytes_acc else float("inf")
        ridge = PEAK_F32 / HBM_BPS  # FLOP/B where compute == bandwidth
        out.update(
            roofline_flops_per_step=flops,
            roofline_bytes_per_step=bytes_acc,
            achieved_tflops=round(achieved / 1e12, 3),
            pct_of_f32_peak=round(100.0 * achieved / PEAK_F32, 2),
            **note,
            arithmetic_intensity_flop_per_byte=round(intensity, 2),
            ridge_flop_per_byte=round(ridge, 1),
            bound="memory" if intensity < ridge else "compute",
            hbm_utilization_pct=round(
                100.0 * (bytes_acc / step_s) / HBM_BPS, 2
            ) if step_s else 0.0,
        )
    except Exception as e:  # cost model unavailable on some backends
        out["roofline_error"] = f"{type(e).__name__}: {e}"[:160]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
