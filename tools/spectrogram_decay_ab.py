"""On-device A/B: decay_domain routing for the spectrogram step (cfg4).

The spectrogram family forces ``decay_domain="linear"`` because, on the
previous accelerator, the log-domain decay+dB composed slower with the
downstream ``spectrogram_columns`` consumer at cfg4 geometry (16384-pt
window, T=512 columns, P=1024) although it sped up the headline step.
On the GPU this is not measured yet. This tool measures the decision
rows (log vs linear full step, plus the isolated analyze and colormap)
so the routing can be re-decided:

    python tools/spectrogram_decay_ab.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
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
    from signalizer_tpu.kernels.colormap import normalize_ratios, spectrogram_columns
    from signalizer_tpu.kernels.peak_decay import peak_decay_scan
    from signalizer_tpu.views.spectrogram import DEFAULT_GRADIENT, DEFAULT_RATIOS

    c4 = make_spectrum_constant(
        axis_points=1024,
        window_size=16384,
        sample_rate=48_000.0,
        configuration=SpectrumChannels.LEFT,
        bin_interpolation=BinInterpolation.LINEAR,
        view_scaling=ViewScaling.LOGARITHMIC,
        display_mode=1,
    )
    colours = jnp.asarray(DEFAULT_GRADIENT[None])
    ratios = jnp.asarray(normalize_ratios(DEFAULT_RATIOS), jnp.float32)
    t4 = 512
    valid4 = jnp.ones((t4,), bool)
    rng = np.random.default_rng(0)
    f4 = jnp.asarray(rng.standard_normal((1, t4, 2, 16384)).astype(np.float32))
    s4 = sp.init_line_graph_state(c4, (1,))
    hold0 = jnp.zeros((1024,), jnp.float32)
    out = {"device": str(jax.devices()[0])}

    def measure(name, body, carry, per=t4):
        sec, meta = _scan_rate(body, carry, k1=2, k2=16)
        out[name + "_us_per_frame"] = round(sec / per * 1e6, 4)
        out[name + "_fps"] = round(per / sec, 1)
        if meta.get("degraded"):
            out[name + "_degraded"] = True
        print(f"  {name}: {out[name + '_fps']} f/s", file=sys.stderr)

    def sg_body(domain):
        def body(c):
            state, h, x, acc = c
            r = sp.analyze_frames(c4, state, x, valid=valid4, decay_domain=domain)
            intensity = r.results[:, :, 0, 0, :]
            cols = spectrogram_columns(intensity, colours, ratios)
            held, nh = peak_decay_scan(h, intensity[0], 1.0, time_axis=0)
            checksum = jnp.sum(cols.astype(jnp.float32)) + jnp.sum(held)
            return r.state, nh, jnp.roll(x, 1, axis=-1), acc + checksum

        return body

    def analyze_body(domain):
        def body(c):
            st, x, acc = c
            r = sp.analyze_frames(c4, st, x, valid=valid4, decay_domain=domain)
            return r.state, jnp.roll(x, 1, axis=-1), acc + jnp.sum(r.results)

        return body

    def cols_body(c):
        inten, acc = c
        cols = spectrogram_columns(inten, colours, ratios)
        return jnp.roll(inten, 1, axis=-1), acc + jnp.sum(cols.astype(jnp.float32))

    measure("sg_linear", sg_body("linear"), (s4, hold0, f4, jnp.float32(0.0)))
    measure("sg_log", sg_body("log"), (s4, hold0, f4, jnp.float32(0.0)))
    measure("analyze_log", analyze_body("log"), (s4, f4, jnp.float32(0.0)))
    inten0 = jnp.asarray(rng.standard_normal((1, t4, 1024)).astype(np.float32))
    measure("cols_alone", cols_body, (inten0, jnp.float32(0.0)))

    # parity between the two routings (display tolerance)
    a = jax.jit(
        lambda s, f: sp.analyze_frames(c4, s, f, valid=valid4, decay_domain="log")
    )(s4, f4)
    b = jax.jit(
        lambda s, f: sp.analyze_frames(c4, s, f, valid=valid4, decay_domain="linear")
    )(s4, f4)
    out["routing_parity_max_abs"] = float(jnp.max(jnp.abs(a.results - b.results)))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
