"""A/B on the H100 that decided the oscilloscope resample and the spectrum
FFT: the per-tap gather against the XLA block-banded resample (widths 64
and 256) and the old platform routing, at the cfg3 and session
geometries; jnp.fft (cuFFT) against the four-step matmul DFT; and a short
session bring-up. ab.json beside this file is what it printed.

The band resample and the matmul DFT were removed after this A/B, so it
runs from a checkout of the commit before their removal (the parent of
the commit that deleted signalizer_tpu/kernels/mxu_fft.py):

    git archive <that commit> | tar -x -C old && cd old && python <this file> [out.json]

Times in us: host-chained medians [p50, p25, p75] of 10 chained calls, and
``*_device_us``, the slope of a scanned loop of 4 vs 36 steps (device time
per step without dispatch). ``*_maxdiff_*`` is the largest absolute
difference of a resample form's waveform from the gather's.
"""
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

sys.path.insert(0, os.getcwd())
import numpy as np
import jax
import jax.numpy as jnp

try:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
except OSError as e:
    print("no nvidia-smi", e)
print(jax.__version__, jax.devices(), flush=True)
CPU = bool(os.environ.get("AB_CPU"))
assert CPU or jax.devices()[0].platform == "gpu"
RES = {}


def timeit(f, *args, reps=25, chain=10):
    out = f(*args)
    jax.block_until_ready(out)
    out = f(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(chain):
            out = f(*args)
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / chain)
    ts = np.asarray(ts) * 1e6
    return [float(np.median(ts)), float(np.percentile(ts, 25)), float(np.percentile(ts, 75))]


def scan_slope(body, carry, k1=4, k2=36, reps=5):
    @jax.jit
    def run1(c):
        return jax.lax.fori_loop(0, k1, lambda i, c: body(c), c)

    @jax.jit
    def run2(c):
        return jax.lax.fori_loop(0, k2, lambda i, c: body(c), c)

    for r in (run1, run2):
        jax.block_until_ready(r(carry))

    def med(r):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(r(carry))
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    return (med(run2) - med(run1)) / (k2 - k1) * 1e6


def rec(key, val):
    RES[key] = val
    print(key, val, flush=True)


# ---------------------------------------------------------------- resample
import signalizer_tpu.kernels.oscilloscope as ko

orig_dispatch = ko._banded_dispatch


def make_route(route):
    def dispatch(x, pos, step, num_out, support, kind, gather_fallback):
        if route == "current":
            return orig_dispatch(x, pos, step, num_out, support, kind, gather_fallback)
        if route == "gather" or num_out % ko._BAND_BLOCK:
            return gather_fallback()
        width = 64 if route == "band64" else 256
        return ko._banded_resample(x, pos, support, width, kind)
    return dispatch


def fits(step, width, a=10):
    return step * 127 + 2 * a + 2 <= width


from signalizer_tpu.core.config import OscChannels
from signalizer_tpu.views.oscilloscope import (
    OscilloscopeProcessor, SubSampleInterpolation, TriggerMode, osc_step_impl)

GEOMS = {
    # cfg3: 16 pairs x 2 rows x 8192 px from 16384 samples at 96 kHz, window 1024
    "cfg3": dict(pairs=16, fs=96000.0, px=8192, win=1024.0, h=16384, la=8192),
    # session geometry: 1 pair, 1920 px, 16384-sample history, ~20 ms window
    "session": dict(pairs=1, fs=48000.0, px=1920, win=960.0, h=16384, la=8192),
    "session_wide": dict(pairs=1, fs=48000.0, px=1920, win=4800.0, h=16384, la=8192),
}
if CPU:
    GEOMS = {k: dict(v, pairs=1, px=256, h=4096, la=1024, win=v["win"]/8) for k, v in GEOMS.items()}
rng = np.random.default_rng(0)
for gname, g in GEOMS.items():
    step = (g["win"] - 1) / (g["px"] - 1)
    rec(f"{gname}_step", step)
    t = np.arange(g["h"])
    x = (0.5 * np.sin(2 * np.pi * 440.0 * t / g["fs"]) + 0.05 * rng.standard_normal(g["h"])).astype(np.float32)
    hist = jnp.asarray(np.broadcast_to(x, (g["pairs"], 2, g["h"])).copy())
    start = jnp.asarray(rng.uniform(0, g["h"] - g["win"] - 1, (g["pairs"], 1)).astype(np.float32))
    stp = jnp.full((g["pairs"], 1), step, jnp.float32)
    for route in ("gather", "band64", "band256", "current"):
        if route == "band64" and not fits(step, 64):
            continue
        if route == "band256" and not fits(step, 256):
            continue
        ko._banded_dispatch = make_route(route)
        try:
            f = jax.jit(lambda xx, s0: ko.sinc_resample(xx, s0, stp, g["px"]))
            rec(f"{gname}_resample_{route}_us", timeit(f, hist, start))
            wave = np.asarray(f(hist, start))
            RES.setdefault(f"{gname}_waves", {})[route] = wave
            fn = jax.jit(lambda xx, s0: ko.nearest_resample(xx, s0, stp, g["px"]))
            rec(f"{gname}_nearest_{route}_us", timeit(fn, hist, start))
            osc = OscilloscopeProcessor(
                pairs=g["pairs"], sample_rate=g["fs"], channel_mode=OscChannels.SEPARATE,
                trigger_mode=TriggerMode.ZERO_CROSSING,
                interpolation=SubSampleInterpolation.LANCZOS, window_samples=g["win"],
                pixels=g["px"], lookahead=g["la"], trigger_threshold=0.1, autogain=True)
            win = jnp.float32(g["win"])
            env_os = max(1, 1 << int(np.ceil(np.log2(max(step, 1e-9)))) ) if step > 1 else 1

            @jax.jit
            def osc_step(st, xx):
                fr, nst = osc_step_impl(osc.constant, st, xx, win, jnp.float32(0.0),
                                        jnp.float32(800.0), None, env_os=env_os)
                return fr.waveform, fr.envelope_max, nst
            st = osc.state
            rec(f"{gname}_oscstep_{route}_us", timeit(lambda xx: osc_step(st, xx)[:2], hist))

            def body(c):
                s, xx = c
                w_, e_, ns = osc_step(s, xx)
                return ns, jnp.roll(xx, 1, axis=-1) + 1e-7 * jnp.sum(w_)
            if gname != "session_wide":
                rec(f"{gname}_oscstep_{route}_device_us", scan_slope(body, (st, hist)))
        except Exception as e:
            rec(f"{gname}_{route}_error", repr(e)[:300])
            traceback.print_exc()
    ko._banded_dispatch = orig_dispatch
    waves = RES.pop(f"{gname}_waves", {})
    if "gather" in waves:
        for k, v in waves.items():
            rec(f"{gname}_maxdiff_{k}_vs_gather", float(np.max(np.abs(v - waves["gather"]))))

# --------------------------------------------------------------------- FFT
from signalizer_tpu.kernels.mxu_fft import make_plan, mxu_rfft_half

for n, batch in (((4096, 8), (16384, 2)) if CPU else ((4096, 4096), (16384, 512))):
    xr = jnp.asarray(rng.standard_normal((batch, n)).astype(np.float32))
    plan = make_plan(n)
    f_x = jax.jit(lambda a: jnp.abs(jnp.fft.rfft(a, axis=-1)))
    f_m = jax.jit(lambda a: jnp.hypot(*mxu_rfft_half(plan, a, precision=jax.lax.Precision.HIGHEST)))
    rec(f"fft{n}_b{batch}_cufft_us", timeit(f_x, xr))
    rec(f"fft{n}_b{batch}_mxu_highest_us", timeit(f_m, xr))
    ref = np.abs(np.fft.rfft(np.asarray(xr, np.float64)[:8], axis=-1))
    for nm, f in (("cufft", f_x), ("mxu_highest", f_m)):
        got = np.asarray(f(xr))[:8]
        rec(f"fft{n}_{nm}_maxrel", float(np.max(np.abs(got - ref)) / np.max(ref)))

from signalizer_tpu.core.config import BinInterpolation, SpectrumChannels, ViewScaling
from signalizer_tpu.core.constant import make_spectrum_constant
from signalizer_tpu.kernels.spectrum import analyze_frames, init_line_graph_state

frames = jnp.asarray(rng.standard_normal((16, 2 if CPU else 128, 2, 4096)).astype(np.float32))
for be, prec in (("xla", None), ("mxu", "highest")):
    c = make_spectrum_constant(axis_points=1024, window_size=4096, configuration=SpectrumChannels.SEPARATE,
                               bin_interpolation=BinInterpolation.LINEAR,
                               view_scaling=ViewScaling.LOGARITHMIC, fft_backend=be, fft_precision=prec)
    s0 = init_line_graph_state(c, (16,))
    f = jax.jit(lambda s, fr, c=c: jnp.sum(analyze_frames(c, s, fr).results))
    rec(f"headline_step_{be}_us", timeit(f, s0, frames, reps=10, chain=4))

# -------------------------------------------------------- session bring-up
from signalizer_tpu.utils.exception_log import set_exception_log_path
logp = os.path.join(tempfile.mkdtemp(), "exceptions.log")
set_exception_log_path(logp)
from signalizer_tpu.engine import SignalizerEngine
from signalizer_tpu.session import AnalysisSession
from signalizer_tpu.stream.audio_stream import Playhead
from signalizer_tpu import native_bindings
print("native", native_bindings.native_available(), native_bindings.native_build_error(), flush=True)

for preset in (None, "constantQ.spectrum"):
    eng = SignalizerEngine("ab", load_default_preset=False)
    if preset:
        print("preset loaded", eng.load_preset(preset), flush=True)
    sess = AnalysisSession(eng, axis_points=1024, pixels=1920)
    t0 = time.perf_counter()
    tpos = 0
    lat = []
    for i in range(6 if CPU else 60):
        for _ in range(3):
            blk = (0.3 * rng.standard_normal((2, 256))).astype(np.float32)
            tpos += 256
            sess.feed(blk, Playhead(steady_clock=tpos, bpm=120.0, is_playing=True))
        ta = time.perf_counter()
        fr = sess.tick()
        lat.append(time.perf_counter() - ta)
    rec(f"session_{preset}_setup_plus_60ticks_s", time.perf_counter() - t0)
    rec(f"session_{preset}_tick_p50_ms", float(np.median(lat[len(lat)//3:]) * 1e3))
    rec(f"session_{preset}_fields", {k: (v is not None) for k, v in fr._asdict().items()})
    sess.close()
print("EXC LOG:", open(logp).read()[-6000:] if os.path.exists(logp) else "(empty)", flush=True)
json.dump(RES, open(sys.argv[1] if len(sys.argv) > 1 else "ab.json", "w"), indent=1, default=str)
print("DONE", flush=True)
