"""Benchmark harness — the BASELINE configs on the GPU.

Headline metric (driver BASELINE.json): stereo 4096-pt spectrum
frames/sec at 48 kHz and p50 frame latency. Prints one cumulative JSON
line after EVERY config completes (each a superset of the previous), so
the LAST stdout line is always the most complete parseable record even
when the run is killed mid-way; a wall-clock budget
(``SZ_BENCH_BUDGET_S``, default 900 s) skips + names remaining configs
rather than overrunning.

Process layout: the parent never imports JAX. It checks once that a GPU
is present (a child process prints the device stamp) and then runs each
config in its own child process, one after another, so exactly one
process holds the card at a time (a JAX process reserves most of the
card's memory when it first touches it). The children share the
persistent compile cache (``signalizer_tpu.utils.device``). No config
ever falls back to the CPU: a child that finds no GPU exits non-zero.
Every record carries the device stamp (platform, device kind, device
count, the card's name and power limit).

Throughput keys time chained async dispatches per synchronization;
``on_device`` keys take the slope between two ``lax.scan`` lengths, so
per-dispatch host cost cancels. Each measured function returns a scalar
checksum folded from its outputs, which cannot exist until the compute
ran.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# make the package importable regardless of the invoking cwd
sys.path.insert(0, str(Path(__file__).resolve().parent))

# Ordered by importance: the run may be killed at any point, and the LAST
# stdout line must already carry the most valuable keys. "headline" is
# throughput-only so its value lands first.
CONFIG_NAMES = (
    "headline", "latency", "device", "local", "cfg1", "cfg2", "cfg3",
    "cfg4", "cfg5", "pipeline", "ring", "cfg3b", "cfg4b", "cfg6",
)

# total wall-clock budget for the isolated runner (probe included);
# remaining configs are skipped — and named in ``skipped_configs`` —
# once it runs out, so the run always ENDS with a parseable superset
# line instead of being cut mid-config
DEFAULT_BUDGET_S = 900.0

# per-config partial results persist here as each child completes, so a
# run that dies mid-way still leaves what it measured
PARTIAL_PATH = Path(__file__).resolve().with_name("bench_partial.json")

# every completed run also appends a capture here; published numbers are
# medians over N runs with spread via tools/bench_aggregate.py
RUNS_DIR = Path(__file__).resolve().with_name("bench_runs")

# Published peaks per card, keyed by JAX's ``device_kind`` (NVIDIA H100
# SXM5 data sheet, dense rates at the 700 W power limit). A card that is
# not listed is an error, never assumed to be an H100.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,  # float32 outside the tensor cores
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
        "rated_power_w": 700.0,  # the power limit these rates assume
    },
}


def device_peaks(device_kind: str) -> dict:
    """The published peak table for ``device_kind``; KeyError if unknown."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind {device_kind!r}") from None


def peak_share_note(peaks: dict, power_limit_w) -> dict:
    """The power limit a share of ``peaks`` was taken at, beside the limit
    the peaks are rated at. A card capped below its rating runs slower
    under load while reporting the same ``device_kind``, so its shares
    read low; ``shares_below_rated_power`` flags them (an unknown limit
    counts as below)."""
    rated = peaks["rated_power_w"]
    return {
        "power_limit_w": power_limit_w,
        "peaks_rated_at_w": rated,
        "shares_below_rated_power": power_limit_w is None or power_limit_w < rated,
    }


def _save_partial(parts: dict) -> None:
    try:
        PARTIAL_PATH.write_text(json.dumps(parts))
    except OSError:
        pass


def _save_run(parts: dict, coverage: dict | None = None) -> None:
    """Persist a completed run capture for tools/bench_aggregate.py.

    ``coverage`` (skipped_configs / timed_out_configs) rides along as
    list-valued metadata — the aggregator's ``_is_measurement`` ignores
    non-numeric values — so a reader of ``bench_runs/`` can tell a
    budget-truncated capture (cfgN keys absent because the config never
    ran) from a config that ran and failed."""
    if not parts:
        return
    record = dict(parts)
    for key, value in (coverage or {}).items():
        if value:
            record[key] = list(value)
    try:
        RUNS_DIR.mkdir(exist_ok=True)
        (RUNS_DIR / f"run_{int(time.time())}.json").write_text(json.dumps(record))
    except OSError:
        pass


def _load_partial() -> dict:
    try:
        return json.loads(PARTIAL_PATH.read_text())
    except (OSError, json.JSONDecodeError):
        return {}


def _timeit(fn, *args, reps=10, warmup=2, chain=8):
    """Median seconds per call at steady state (chained async dispatch)."""
    import jax

    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(chain):
            out = fn(*args)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / chain)
    return float(np.median(times))


def _scan_rate(body, init_carry, k1=8, k2=64, reps=5):
    """True on-device seconds per step. One dispatch runs ``length``
    sequential steps under ``lax.scan`` (state threads through the carry),
    so per-dispatch host cost appears once per *call*, not per step, and
    cancels exactly in the slope between the two lengths.
    ``body`` must keep every measured output live through the carry
    (e.g. fold sums into a scalar) or XLA dead-code-eliminates it.

    Returns ``(sec_per_step, meta)``. Two INDEPENDENT slope estimates must
    agree within 30% or the key is re-measured once and flagged
    ``degraded``: the slope cancels only additive per-call cost, so
    anything that scales device time with scan length (a throttled or
    shared card) shows up as disagreement. Publish the flag."""
    import functools

    import jax
    from jax import lax

    @functools.partial(jax.jit, static_argnames="length")
    def run(carry, length):
        return lax.scan(lambda c, _: (body(c), None), carry, None, length=length)[0]

    for k in (k1, k2):
        jax.block_until_ready(run(init_carry, k))

    def med(k):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(run(init_carry, k))
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[reps // 2]

    def slope():
        return max((med(k2) - med(k1)) / (k2 - k1), 1e-9)

    slopes = [slope(), slope()]
    spread = abs(slopes[0] - slopes[1]) / min(slopes)
    if spread <= 0.30:
        return float(np.mean(slopes)), {"degraded": False, "spread": round(spread, 3)}
    slopes.append(slope())
    s = sorted(slopes)
    lo_pair, hi_pair = (s[0], s[1]), (s[1], s[2])
    pair = lo_pair if (s[1] - s[0]) <= (s[2] - s[1]) else hi_pair
    pspread = (pair[1] - pair[0]) / max(pair[0], 1e-12)
    meta = {
        "degraded": True,
        "recovered": bool(pspread <= 0.30),
        "spread": round(pspread, 3),
        "slopes_us": [round(x * 1e6, 3) for x in slopes],
    }
    rate = float(np.mean(pair)) if pspread <= 0.30 else float(np.median(slopes))
    return rate, meta


def _scan_key(out: dict, key: str, work_per_step: float, body, carry, **kw) -> None:
    """Record a scan-slope throughput key plus its degraded-capture flags."""
    rate, meta = _scan_rate(body, carry, **kw)
    out[key] = round(work_per_step / rate, 1)
    if meta.get("degraded"):
        out[key + "_degraded"] = True
        out[key + "_spread"] = meta["spread"]
        if not meta.get("recovered", False):
            out[key + "_slopes_us"] = meta["slopes_us"]


def main(only: str = None) -> None:
    import jax

    from signalizer_tpu.utils.device import device_stamp, enable_compile_cache

    enable_compile_cache()
    stamp = device_stamp()
    if stamp["platform"] != "gpu":
        # never measure on the CPU under a device metric's name
        raise SystemExit(f"bench: no GPU found (JAX platform {stamp['platform']!r})")
    import jax.numpy as jnp

    from signalizer_tpu.core.config import (
        BinInterpolation,
        OscChannels,
        SpectrumChannels,
        ViewScaling,
    )
    from signalizer_tpu.core.constant import make_spectrum_constant
    from signalizer_tpu.kernels.peak_decay import peak_decay_scan
    from signalizer_tpu.kernels.spectrum import analyze_frames, init_line_graph_state

    def want(name: str) -> bool:
        return only is None or only == name

    rng = np.random.default_rng(0)
    out = dict(stamp)

    def _headline_constant():
        return make_spectrum_constant(
            axis_points=1024,
            window_size=4096,
            sample_rate=48_000.0,
            configuration=SpectrumChannels.SEPARATE,
            bin_interpolation=BinInterpolation.LINEAR,
            view_scaling=ViewScaling.LOGARITHMIC,
        )

    if want("headline"):
        constant = _headline_constant()

        @jax.jit
        def spectrum_batch(state, frames):
            r = analyze_frames(constant, state, frames)
            # scalar checksum: see module docstring (lazy array blocks)
            return jnp.sum(r.results), r.state

        # pairs are the framework's scaling axis, matching the
        # reference's pairs parallel_for (SpectrumDSP.cpp:83)
        pairs, t_steps = 16, 128
        frames = jnp.asarray(rng.standard_normal((pairs, t_steps, 2, 4096)).astype(np.float32))
        state = init_line_graph_state(constant, (pairs,))
        checksum, state = spectrum_batch(state, frames)
        jax.block_until_ready(checksum)
        dt = _timeit(lambda f: spectrum_batch(state, f)[0], frames)
        throughput = pairs * t_steps / dt
        out.update(
            metric="spectrum_frames_per_sec_per_chip_4096pt_stereo",
            value=round(throughput, 1),
            unit="frames/s",
            vs_baseline=round(throughput / 1000.0, 3),
            # routing provenance: the Constant's static routing field
            # that produced these numbers (resolved at construction)
            remap_mode=constant.remap_mode,
        )

    if want("latency"):
        constant = _headline_constant()

        # latency: single-frame host->device->host round trip
        @jax.jit
        def spectrum_single(state, frame):
            r = analyze_frames(constant, state, frame)
            return r.results[:, 0, 0], r.state

        lat_state = init_line_graph_state(constant, (1,))
        host_frame = rng.standard_normal((1, 1, 2, 4096)).astype(np.float32)
        row, lat_state = spectrum_single(lat_state, jnp.asarray(host_frame))
        np.asarray(row)
        lats = []
        for _ in range(150):
            t0 = time.perf_counter()
            row, lat_state = spectrum_single(lat_state, jnp.asarray(host_frame))
            np.asarray(row)
            lats.append(time.perf_counter() - t0)
        out["p50_latency_ms"] = round(float(np.percentile(lats, 50) * 1e3), 4)
        out["p99_latency_ms"] = round(float(np.percentile(lats, 99) * 1e3), 4)

    if want("device"):
        constant = _headline_constant()

        @jax.jit
        def spectrum_single(state, frame):
            r = analyze_frames(constant, state, frame)
            return r.results[:, 0, 0], r.state

        lat_state = init_line_graph_state(constant, (1,))
        host_frame = rng.standard_normal((1, 1, 2, 4096)).astype(np.float32)

        # on-device step latency: K state-chained single-frame steps inside
        # ONE dispatch (lax.scan). Two chain lengths, slope = per-step
        # device time — the additive per-call cost cancels exactly.
        def chained(k):
            @jax.jit
            def run(state, frame):
                def body(carry, _):
                    st, fr = carry
                    r = analyze_frames(constant, st, fr)
                    # rotate the frame per step — a loop-invariant input
                    # lets XLA hoist the FFT out of the scan, and the
                    # "on-device step" then measures only the state
                    # update
                    return (r.state, jnp.roll(fr, 1, axis=-1)), r.results[:, 0, 0]

                (st, _), rows = jax.lax.scan(body, (state, frame), None, length=k)
                return rows[-1], st

            return run

        # chain lengths far enough apart that the device-time delta
        # clears per-call jitter; minima are the robust statistic for a
        # latency floor
        k_lo, k_hi = 64, 8256
        run_lo, run_hi = chained(k_lo), chained(k_hi)
        dev_frame = jnp.asarray(host_frame)
        for run in (run_lo, run_hi):  # warm both shapes before timing
            r0, _ = run(lat_state, dev_frame)
            np.asarray(r0)

        def step_slope_us():
            mins = []
            for run in (run_lo, run_hi):
                times = []
                for _ in range(6):
                    t0 = time.perf_counter()
                    r0, _ = run(lat_state, dev_frame)
                    np.asarray(r0)
                    times.append(time.perf_counter() - t0)
                mins.append(float(np.min(times)))
            return max(mins[1] - mins[0], 0.0) / (k_hi - k_lo) * 1e6

        # two independent estimates must agree within 30% (same degraded-
        # capture guard as _scan_rate)
        vals = [step_slope_us(), step_slope_us()]
        spread = abs(vals[0] - vals[1]) / max(min(vals), 1e-9)
        if spread > 0.30:
            vals.append(step_slope_us())
            out["on_device_step_us_degraded"] = True
            out["on_device_step_us_slopes"] = [round(v, 3) for v in vals]
        out["on_device_step_us"] = round(float(np.median(vals)), 3)
        out["on_device_step_us_spread"] = round(spread, 3)

        # on-device THROUGHPUT at the headline batch (single-stream
        # latency above is FFT-latency-bound; the card's frame rate is
        # set by the batched pipeline)
        @jax.jit
        def spectrum_batch(state, frames):
            r = analyze_frames(constant, state, frames)
            return jnp.sum(r.results), r.state

        pairs, t_steps = 16, 128
        frames = jnp.asarray(
            rng.standard_normal((pairs, t_steps, 2, 4096)).astype(np.float32)
        )
        state = init_line_graph_state(constant, (pairs,))
        checksum, state = spectrum_batch(state, frames)
        jax.block_until_ready(checksum)

        def batch_body(c):
            st, fr, acc = c
            r = analyze_frames(constant, st, fr)
            return r.state, jnp.roll(fr, 1, axis=-1), acc + jnp.sum(r.results)

        _scan_key(
            out,
            "on_device_frames_per_sec",
            pairs * t_steps,
            batch_body,
            (state, frames, jnp.float32(0.0)),
        )

    if want("pipeline"):
        # pipelined ingest — the production-shaped path (the reference
        # decouples DSP from display with a 10-deep lock-free frame
        # queue, Spectrum.h:139-143): keep frames in flight so the
        # upload of frame t+1 overlaps the compute of frame t, and
        # consume non-blockingly via is_ready.
        from signalizer_tpu.stream.frame_pipeline import FramePipeline

        cp = make_spectrum_constant(
            axis_points=1024,
            window_size=4096,
            sample_rate=48_000.0,
            configuration=SpectrumChannels.SEPARATE,
            bin_interpolation=BinInterpolation.LINEAR,
            view_scaling=ViewScaling.LOGARITHMIC,
        )

        @jax.jit
        def pipe_step(state, frame):
            r = analyze_frames(cp, state, frame)
            return jnp.sum(r.results[:, 0, 0]), r.state

        host_frame = rng.standard_normal((1, 1, 2, 4096)).astype(np.float32)
        warm_state = init_line_graph_state(cp, (1,))
        c0, warm_state = pipe_step(warm_state, jnp.asarray(host_frame))
        jax.block_until_ready(c0)
        # depth must cover completion latency x production rate or
        # backpressure blocks
        pipe = FramePipeline(pipe_step, init_line_graph_state(cp, (1,)), depth=32)
        n_frames = 400
        completions = []
        t0 = time.perf_counter()
        for i in range(n_frames):
            for _ in pipe.submit(host_frame):
                completions.append(time.perf_counter())
        for _ in pipe.drain():
            completions.append(time.perf_counter())
        t1 = time.perf_counter()
        assert pipe.frames_completed == n_frames
        # steady-state per-frame host cost of the pipelined path (wall /
        # frames; the ramp-up and final notification wait amortize in)
        out["pipelined_frame_ms"] = round((t1 - t0) / n_frames * 1e3, 4)
        gaps = np.diff(np.asarray(completions[10:]))
        out["pipelined_p50_ms"] = round(float(np.percentile(gaps, 50) * 1e3), 4)
        out["pipelined_p99_ms"] = round(float(np.percentile(gaps, 99) * 1e3), 4)
        # decomposition: producer-side cost (async submit, no completion
        # wait) vs the drain of the completions.
        pipe2 = FramePipeline(
            pipe_step, init_line_graph_state(cp, (1,)), depth=1 << 30
        )
        n2 = 64
        t0 = time.perf_counter()
        for _ in range(n2):
            pipe2.submit(host_frame)
        t1 = time.perf_counter()
        pipe2.drain(timeout_s=60.0)
        t2 = time.perf_counter()
        out["pipelined_submit_ms"] = round((t1 - t0) / n2 * 1e3, 4)
        out["pipelined_drain_ms_per_frame"] = round((t2 - t1) / n2 * 1e3, 4)

    if want("ring"):
        # hop-only ingest (device-resident history ring): the reference
        # reads windows in place from its history ring
        # (TransformDSP.inl:38-231); with the ring resident in HBM only
        # the NEW samples cross the link per frame, so the submit cost
        # scales with hop bytes instead of window bytes. Measured at two
        # overlaps of the headline geometry (4096-pt stereo window):
        # 50% (hop 2048 = 16 KB/frame) and 93.75% (hop 256 = 2 KB/frame),
        # against the 32 KB full-window path ("pipeline" config).
        from signalizer_tpu.stream.device_ring import ring_update
        from signalizer_tpu.stream.frame_pipeline import FramePipeline

        cr = make_spectrum_constant(
            axis_points=1024,
            window_size=4096,
            sample_rate=48_000.0,
            configuration=SpectrumChannels.SEPARATE,
            bin_interpolation=BinInterpolation.LINEAR,
            view_scaling=ViewScaling.LOGARITHMIC,
        )
        h = 16384
        for hop in (2048, 256):

            @jax.jit
            def ring_tick(state, block, _c=cr):
                ring, lg = state
                ring = ring_update(ring, block, block.shape[-1])
                win = jax.lax.slice_in_dim(ring, h - 4096, h, axis=-1)
                r = analyze_frames(_c, lg, win[:, None])  # [1,1,2,4096]
                return r.results[:, 0, 0, 0], (ring, r.state)

            state0 = (
                jnp.zeros((1, 2, h), jnp.float32),
                init_line_graph_state(cr, (1,)),
            )
            host_block = rng.standard_normal((1, 2, hop)).astype(np.float32)
            # warm
            row, st = ring_tick(state0, jnp.asarray(host_block))
            np.asarray(row)
            # end-to-end per-frame latency: upload, step, row readback
            lats = []
            for _ in range(100):
                t0 = time.perf_counter()
                row, st = ring_tick(st, jnp.asarray(host_block))
                np.asarray(row)
                lats.append(time.perf_counter() - t0)
            key = f"ring_hop{hop}"
            out[f"{key}_p50_ms"] = round(float(np.percentile(lats, 50) * 1e3), 4)
            # producer-side pipelined submit cost
            pipe = FramePipeline(
                ring_tick,
                (
                    jnp.zeros((1, 2, h), jnp.float32),
                    init_line_graph_state(cr, (1,)),
                ),
                depth=1 << 30,
            )
            n2 = 64
            t0 = time.perf_counter()
            for _ in range(n2):
                pipe.submit(host_block)
            t1 = time.perf_counter()
            pipe.drain(timeout_s=60.0)
            out[f"{key}_submit_ms"] = round((t1 - t0) / n2 * 1e3, 4)

    if want("local"):
        # the BASELINE p50 < 1 ms frame-latency target: an end-to-end
        # tick on the card (hop-only ingest -> window -> FFT -> remap ->
        # decay -> dB -> host readback of the display row), which
        # includes jit dispatch + H2D + compute + D2H.
        from signalizer_tpu.stream.device_ring import ring_update

        cl = make_spectrum_constant(
            axis_points=1024,
            window_size=4096,
            sample_rate=48_000.0,
            configuration=SpectrumChannels.SEPARATE,
            bin_interpolation=BinInterpolation.LINEAR,
            view_scaling=ViewScaling.LOGARITHMIC,
        )
        h = 16384
        hop = 2048

        @jax.jit
        def local_tick(state, block):
            ring, lg = state
            ring = ring_update(ring, block, block.shape[-1])
            win = jax.lax.slice_in_dim(ring, h - 4096, h, axis=-1)
            r = analyze_frames(cl, lg, win[:, None])
            return r.results[:, 0, 0, 0], (ring, r.state)

        st = (jnp.zeros((1, 2, h), jnp.float32), init_line_graph_state(cl, (1,)))
        host_block = rng.standard_normal((1, 2, hop)).astype(np.float32)
        row, st = local_tick(st, jnp.asarray(host_block))
        np.asarray(row)
        lats = []
        for _ in range(300):
            t0 = time.perf_counter()
            row, st = local_tick(st, jnp.asarray(host_block))
            np.asarray(row)
            lats.append(time.perf_counter() - t0)
        out["local_e2e_p50_ms"] = round(float(np.percentile(lats, 50) * 1e3), 4)
        out["local_e2e_p99_ms"] = round(float(np.percentile(lats, 99) * 1e3), 4)

        # the same transport-free latency story for the OSCILLOSCOPE view:
        # ring ingest -> ZC trigger -> resample -> envelope -> waveform
        # readback, per 1024-sample tick, at a small geometry (256 px
        # Lanczos): the point of the local keys is per-tick overhead
        # (cfg3 measures the full display geometry)
        from signalizer_tpu.views.oscilloscope import (
            OscilloscopeProcessor,
            SubSampleInterpolation,
            TriggerMode,
            osc_step_impl,
        )

        osc_l = OscilloscopeProcessor(
            pairs=1,
            sample_rate=48_000.0,
            channel_mode=OscChannels.SEPARATE,
            trigger_mode=TriggerMode.ZERO_CROSSING,
            interpolation=SubSampleInterpolation.LANCZOS,
            window_samples=480.0,
            pixels=256,
            lookahead=1024,
            trigger_threshold=0.05,
            autogain=True,
        )
        oh = 2048
        owin = jnp.float32(480.0)
        ons = jnp.float32(1024.0)

        @jax.jit
        def osc_local_tick(state, block):
            ring, ost = state
            ring = ring_update(ring, block, block.shape[-1])
            fr, nst = osc_step_impl(
                osc_l.constant, ost, ring, owin, jnp.float32(0.0), ons, None,
                env_os=1,
            )
            return fr.waveform[:, 0], (ring, nst)

        ost = (jnp.zeros((1, 2, oh), jnp.float32), osc_l.state)
        osc_block = rng.standard_normal((1, 2, 1024)).astype(np.float32) * 0.5
        wv, ost = osc_local_tick(ost, jnp.asarray(osc_block))
        np.asarray(wv)
        lats = []
        for _ in range(300):
            t0 = time.perf_counter()
            wv, ost = osc_local_tick(ost, jnp.asarray(osc_block))
            np.asarray(wv)
            lats.append(time.perf_counter() - t0)
        out["local_osc_e2e_p50_ms"] = round(float(np.percentile(lats, 50) * 1e3), 4)
        out["local_osc_e2e_p99_ms"] = round(float(np.percentile(lats, 99) * 1e3), 4)

        # the PRODUCTION drive path, transport-free: AnalysisSession.tick
        # (spectrum + oscilloscope + vectorscope, shared device-resident
        # history ring, hop-only ingest) at a 60 Hz UI cadence. Unlike the
        # two keys above this includes every layer a real embedder runs —
        # engine ingest, listener delivery, per-view Python, the render
        # readbacks, at a small geometry (the cfgs measure display
        # geometry).
        from signalizer_tpu.engine import SignalizerEngine
        from signalizer_tpu.session import AnalysisSession
        from signalizer_tpu.stream.audio_stream import Playhead

        eng_l = SignalizerEngine("bench-local", load_default_preset=False)
        sess_l = AnalysisSession(
            eng_l,
            views=("spectrum", "oscilloscope", "vectorscope"),
            axis_points=256,
            pixels=256,
        )
        blk = 800  # one 60 Hz tick of 48 kHz audio
        t_pos = 0
        lats = []
        for i in range(60 + 240):
            x = rng.standard_normal((2, blk)).astype(np.float32) * 0.5
            t_pos += blk
            sess_l.feed(x, Playhead(steady_clock=t_pos, bpm=120.0, is_playing=True))
            t0 = time.perf_counter()
            fr = sess_l.tick()
            # the tick's own np.asarray readbacks already synced; touch a
            # scalar from each view so nothing resolves lazily
            s = float(fr.spectrum[0, 0, 0]) + float(
                np.asarray(fr.oscilloscope.waveform).flat[0]
            ) + float(np.asarray(fr.vectorscope.vertices).flat[0])
            if i >= 60:
                lats.append(time.perf_counter() - t0)
        sess_l.close()
        out["local_session_p50_ms"] = round(float(np.percentile(lats, 50) * 1e3), 4)
        out["local_session_p99_ms"] = round(float(np.percentile(lats, 99) * 1e3), 4)

    if want("cfg1"):
        c1 = make_spectrum_constant(
            axis_points=513,
            window_size=1024,
            sample_rate=48_000.0,
            configuration=SpectrumChannels.LEFT,
            bin_interpolation=BinInterpolation.LINEAR,
            view_scaling=ViewScaling.LINEAR,
        )

        @jax.jit
        def mono_batch(state, frames):
            r = analyze_frames(c1, state, frames)
            return jnp.sum(r.results), r.state

        p1, t1 = 32, 256
        f1 = jnp.asarray(rng.standard_normal((p1, t1, 2, 1024)).astype(np.float32))
        s1 = init_line_graph_state(c1, (p1,))
        dt = _timeit(lambda f: mono_batch(s1, f)[0], f1)
        out["cfg1_mono1024_frames_per_sec"] = round(p1 * t1 / dt, 1)

    if want("cfg2"):
        from signalizer_tpu.kernels.vectorscope import (
            init_meter_state,
            lissajous_vertices,
            meter_readout,
            polar_vertices,
            update_meters,
        )

        @jax.jit
        def vs_step(state, frames):
            new_state = update_meters(state, frames, envelope_pole=0.999, stereo_pole=0.99)
            liss = lissajous_vertices(frames)
            pol = polar_vertices(frames)
            bars = meter_readout(new_state)
            checksum = jnp.sum(liss) + jnp.sum(pol) + jnp.sum(bars["balance"])
            return checksum, new_state

        b2 = 256
        vf = jnp.asarray(rng.standard_normal((b2, 2, 4096)).astype(np.float32))
        vstate = init_meter_state((b2,))
        dt = _timeit(lambda f: vs_step(vstate, f)[0], vf)
        out["cfg2_vectorscope_frames_per_sec"] = round(b2 / dt, 1)

    if want("cfg3"):
        from signalizer_tpu.views.oscilloscope import (
            OscilloscopeProcessor,
            SubSampleInterpolation,
            TriggerMode,
        )

        osc = OscilloscopeProcessor(
            pairs=16,
            sample_rate=96_000.0,
            channel_mode=OscChannels.SEPARATE,
            trigger_mode=TriggerMode.ZERO_CROSSING,
            interpolation=SubSampleInterpolation.LANCZOS,
            window_samples=1024.0,  # 8x upsample to 8192 pixels
            pixels=8192,
            lookahead=8192,
            trigger_threshold=0.1,
            autogain=True,
        )
        from signalizer_tpu.views.oscilloscope import osc_step_impl

        t = np.arange(16384)
        hist = np.sin(2 * np.pi * 440.0 * t / 96_000.0).astype(np.float32)
        hist_dev = jnp.asarray(np.broadcast_to(hist, (16, 2, 16384)).copy())
        win3 = jnp.float32(1024.0)
        zero3 = jnp.float32(0.0)
        ns3 = jnp.float32(16384.0)

        @jax.jit
        def osc_scalar(st, x):
            # env_os=1 mirrors production: process() passes the pow2 bucket
            # of the actual per-pixel step (1024-sample window over 8192 px
            # is upsampling, so the envelope needs no oversampling)
            fr, nst = osc_step_impl(
                osc.constant, st, x, win3, zero3, ns3, None, env_os=1
            )
            return jnp.sum(fr.waveform) + jnp.sum(fr.envelope_max), nst

        st3 = osc.state
        c0, _ = osc_scalar(st3, hist_dev)
        jax.block_until_ready(c0)
        dt = _timeit(lambda x: osc_scalar(st3, x)[0], hist_dev, reps=10)
        out["cfg3_oscilloscope_frames_per_sec"] = round(16 / dt, 1)

        def osc3_body(c):
            st, x, acc = c
            s, ns = osc_scalar(st, x)
            return ns, jnp.roll(x, 1, axis=-1), acc + s

        _scan_key(
            out, "cfg3_on_device_frames_per_sec", 16,
            osc3_body, (st3, hist_dev, jnp.float32(0.0)),
        )

    if want("cfg3b"):
        # the EXPENSIVE trigger at the same geometry: SPECTRAL mode runs an
        # 8192-pt FFT + the hysteresis/harmonic fundamental walk over 4094
        # bins + the 8-deep median + Goertzel phase lock every frame
        # (ref: OscilloscopeDSP.inl:61-308)
        from signalizer_tpu.views.oscilloscope import (
            OscilloscopeProcessor,
            SubSampleInterpolation,
            TriggerMode,
        )

        osc_b = OscilloscopeProcessor(
            pairs=16,
            sample_rate=96_000.0,
            channel_mode=OscChannels.SEPARATE,
            trigger_mode=TriggerMode.SPECTRAL,
            interpolation=SubSampleInterpolation.LANCZOS,
            window_samples=1024.0,
            pixels=8192,
            lookahead=8192,
            trigger_threshold=0.1,
            autogain=True,
        )
        from signalizer_tpu.views.oscilloscope import osc_step_impl

        t = np.arange(16384)
        hist = np.sin(2 * np.pi * 440.0 * t / 96_000.0).astype(np.float32)
        hist_dev = jnp.asarray(np.broadcast_to(hist, (16, 2, 16384)).copy())
        win_b = jnp.float32(1024.0)
        tp_b = jnp.float32(0.0)
        ns_b = jnp.float32(16384.0)

        @jax.jit
        def oscb_scalar(st, x):
            fr, nst = osc_step_impl(
                osc_b.constant, st, x, win_b, tp_b, ns_b, None, env_os=1
            )
            return jnp.sum(fr.waveform) + jnp.sum(fr.fundamental), nst

        state_b = osc_b.state
        c0, _ = oscb_scalar(state_b, hist_dev)
        jax.block_until_ready(c0)
        dt = _timeit(lambda x: oscb_scalar(state_b, x)[0], hist_dev, reps=10)
        out["cfg3b_spectral_frames_per_sec"] = round(16 / dt, 1)

        def osc_body(c):
            st, x, acc = c
            s, ns = oscb_scalar(st, x)
            # rotate the input so no per-frame work is loop-invariant
            return ns, jnp.roll(x, 1, axis=-1), acc + s

        _scan_key(
            out, "cfg3b_on_device_frames_per_sec", 16,
            osc_body, (state_b, hist_dev, jnp.float32(0.0)),
        )

    if want("cfg4"):
        c4 = make_spectrum_constant(
            axis_points=1024,
            window_size=16384,
            sample_rate=48_000.0,
            configuration=SpectrumChannels.LEFT,
            bin_interpolation=BinInterpolation.LINEAR,
            view_scaling=ViewScaling.LOGARITHMIC,
            display_mode=1,
        )
        from signalizer_tpu.kernels.colormap import normalize_ratios, spectrogram_columns
        from signalizer_tpu.views.spectrogram import DEFAULT_GRADIENT, DEFAULT_RATIOS

        colours = jnp.asarray(DEFAULT_GRADIENT[None])
        ratios = jnp.asarray(normalize_ratios(DEFAULT_RATIOS), jnp.float32)

        # production-shaped step: the tick path always carries the
        # validity mask (SpectrogramProcessor.pull pads to pow2 buckets).
        # T=512 is the honest full-image redraw batch — the default
        # spectrogram image is 512 columns wide, and a zoom/parameter
        # change redraws all of them in one dispatch.
        t4 = 512
        valid4 = jnp.ones((t4,), bool)

        @jax.jit
        def sg_step(state, frames, hold):
            # decay_domain="linear" — the production spectrogram routing
            # (views/spectrogram.py)
            r = analyze_frames(c4, state, frames, valid=valid4, decay_domain="linear")
            intensity = r.results[:, :, 0, 0, :]
            cols = spectrogram_columns(intensity, colours, ratios)
            # 1000-frame peak hold: running max across the time axis
            held, new_hold = peak_decay_scan(hold, intensity[0], 1.0, time_axis=0)
            checksum = jnp.sum(cols.astype(jnp.float32)) + jnp.sum(held)
            return checksum, r.state, new_hold

        f4 = jnp.asarray(rng.standard_normal((1, t4, 2, 16384)).astype(np.float32))
        s4 = init_line_graph_state(c4, (1,))
        hold = jnp.zeros((1024,), jnp.float32)
        res = sg_step(s4, f4, hold)
        jax.block_until_ready(res[0])
        dt = _timeit(lambda f: sg_step(s4, f, hold)[0], f4)
        out["cfg4_spectrogram16k_frames_per_sec"] = round(t4 / dt, 1)

        # on-device rate with the input in the carry and rotated per step:
        # a fixed input lets XLA hoist the whole FFT+remap out of the scan
        # (loop-invariant)
        def sg_body(c):
            state, h, x, acc = c
            checksum, ns, nh = sg_step(state, x, h)
            return ns, nh, jnp.roll(x, 1, axis=-1), acc + checksum

        _scan_key(
            out, "cfg4_on_device_frames_per_sec", t4,
            sg_body, (s4, hold, f4, jnp.float32(0.0)), k1=2, k2=16,
        )

    if want("cfg4b"):
        # the PRODUCTION spectrogram tick path (SpectrogramProcessor.pull:
        # host batcher -> pow2-bucketed masked frames -> ONE dispatch ->
        # RGBA8 columns read back to host for the image). Unlike cfg4's
        # batched device step this includes the host batcher, the bucket
        # padding, and the device->host column readback the render loop
        # genuinely needs — i.e. the per-tick cost an editor pays at
        # ~60 Hz cadence (ref streaming chunker: TransformDSP.inl:1163-1211).
        from signalizer_tpu.views.spectrogram import SpectrogramProcessor

        sp = SpectrogramProcessor(
            pairs=1,
            blob_ms=10.0,
            axis_points=256,
            window_size=4096,
            sample_rate=48_000.0,
        )
        tick_n = 800  # one 60 Hz editor tick of 48 kHz audio
        blocks = rng.standard_normal((240, 2, tick_n)).astype(np.float32) * 0.25
        # warm the pow2 bucket shapes the steady state hits (1 and 2
        # frames/tick at this cadence) plus a backlog bucket. Prime first
        # (frame 0 is its own compiled shape), then force each bucket with
        # an explicit max_frames, so the timed loop pays no compiles.
        hop, win = 480, 4096
        if sp.batcher.frames_ready() == 0:
            sp.push(rng.standard_normal((2, win)).astype(np.float32) * 0.25)
            sp.pull()
        for warm_t in (4, 2, 1, 1, 2):
            sp.push(rng.standard_normal((2, warm_t * hop)).astype(np.float32) * 0.25)
            sp.pull(max_frames=warm_t)
        ticks, lags = [], []
        for i in range(240):
            sp.push(blocks[i])
            t0 = time.perf_counter()
            sp.pull()
            ticks.append(time.perf_counter() - t0)
            lag = sp.freshness_lag()
            if lag is not None:
                lags.append(lag)
        ticks_ms = np.asarray(ticks) * 1e3
        out["cfg4b_pull_tick_p50_ms"] = round(float(np.percentile(ticks_ms, 50)), 4)
        out["cfg4b_pull_tick_p99_ms"] = round(float(np.percentile(ticks_ms, 99)), 4)
        # freshness: samples between the stream clock and the newest
        # emitted frame's end, at pull time — stays below one hop (480):
        # the preliminary-audio stitch semantics (frames form the moment
        # their final sample arrives, TransformDSP.inl:233-484)
        out["cfg4b_freshness_lag_p50_smps"] = round(float(np.percentile(lags, 50)), 1)
        out["cfg4b_freshness_lag_max_smps"] = round(float(np.max(lags)), 1)

    if want("cfg5"):
        c5 = make_spectrum_constant(
            axis_points=1024,
            window_size=4096,
            sample_rate=192_000.0,
            configuration=SpectrumChannels.SEPARATE,
            bin_interpolation=BinInterpolation.LINEAR,
            view_scaling=ViewScaling.LOGARITHMIC,
        )
        from signalizer_tpu.kernels.oscilloscope import (
            minmax_decimate,
            sinc_resample_matrix,
            sinc_resample_static,
        )
        from signalizer_tpu.kernels.vectorscope import (
            correlation,
            init_meter_state,
            update_meters,
        )

        # static pixel grid -> resample as one matmul
        resample_m = sinc_resample_matrix(4096, 0.0, 4096.0 / 1024, 1024)

        @jax.jit
        def fused_step(state, vstate, frames):
            # frames [4 pairs, T, 2, 4096] (8 channels)
            r = analyze_frames(c5, state, frames)
            corr = correlation(frames)
            wave = sinc_resample_static(frames[..., 0, :], resample_m)
            mins, maxs = minmax_decimate(frames[..., 0, :], 1024)
            vnew = update_meters(vstate, frames[:, -1], envelope_pole=0.999, stereo_pole=0.99)
            checksum = (jnp.sum(r.results) + jnp.sum(wave) + jnp.sum(mins)
                        + jnp.sum(maxs) + jnp.sum(corr))
            return checksum, r.state, vnew

        t5 = 128
        f5 = jnp.asarray(rng.standard_normal((4, t5, 2, 4096)).astype(np.float32))
        s5 = init_line_graph_state(c5, (4,))
        v5 = init_meter_state((4,))
        res = fused_step(s5, v5, f5)
        jax.block_until_ready(res[0])
        dt = _timeit(lambda f: fused_step(s5, v5, f)[0], f5)
        out["cfg5_fused8ch192k_frames_per_sec"] = round(4 * t5 / dt, 1)

        def fused_body(c):
            state, vstate, x, acc = c
            checksum, ns, nv = fused_step(state, vstate, x)
            # rotate the input per step so nothing is loop-invariant
            return ns, nv, jnp.roll(x, 1, axis=-1), acc + checksum

        _scan_key(
            out, "cfg5_on_device_frames_per_sec", 4 * t5,
            fused_body, (s5, v5, f5, jnp.float32(0.0)),
        )

    if want("cfg6"):
        # informational (not a BASELINE config): the RSNT resonator bank
        # (complex math inside jit, real-pair boundaries)
        from signalizer_tpu.core.constant import host_view
        from signalizer_tpu.kernels.resonator import (
            init_resonator_state,
            make_block_plan,
            make_resonator_constant,
            resonate_block,
            resonate_chunks,
            resonator_readout,
        )

        c6 = make_spectrum_constant(
            axis_points=1024,
            window_size=4096,
            sample_rate=48_000.0,
            configuration=SpectrumChannels.LEFT,
            bin_interpolation=BinInterpolation.LINEAR,
            view_scaling=ViewScaling.LOGARITHMIC,
        )
        rc = make_resonator_constant(
            np.asarray(host_view(c6, "mapped_frequencies")), 48_000.0, 4096
        )
        pairs6 = 16
        plan6 = make_block_plan(rc, 512)
        st6 = init_resonator_state(rc, (pairs6, 2))

        # production tick path (what the session dispatches): ALL pending
        # chunks ride one scanned dispatch, one readout per chunk (the
        # RSNT spectrogram semantic, ref: continuous resonate,
        # TransformDSP.inl:1163-1211)
        t6 = 16
        chunks6 = jnp.asarray(
            rng.standard_normal((pairs6, 2, t6, 512)).astype(np.float32)
        )
        valid6 = jnp.ones((t6,), bool)

        @jax.jit
        def res_tick(state, chunks):
            st, ys = resonate_chunks(
                rc, state, chunks, valid=valid6, plan=plan6, emit_readouts=True
            )
            return jnp.sum(ys), st

        checksum, _ = res_tick(st6, chunks6)
        jax.block_until_ready(checksum)
        dt = _timeit(lambda ch: res_tick(st6, ch)[0], chunks6)
        out["cfg6_resonator_readouts_per_sec"] = round(pairs6 * t6 / dt, 1)

        # single-block dispatch rate with the precomputed pole-power plan
        @jax.jit
        def res_step(state, block):
            st = resonate_block(rc, state, block, plan6)
            return jnp.sum(resonator_readout(rc, st)), st

        block6 = jnp.asarray(rng.standard_normal((pairs6, 2, 512)).astype(np.float32))
        r6, st6 = res_step(st6, block6)
        jax.block_until_ready(r6)
        dt = _timeit(lambda b: res_step(st6, b)[0], block6)
        out["cfg6_single_block_readouts_per_sec"] = round(pairs6 / dt, 1)

        # on-device rate with the block rotated per step (a fixed input
        # lets XLA hoist the drive matmul out of the scan). Steps are
        # ~us-scale: the chain spread must clear per-call jitter, hence
        # the wide k2.
        def res_body(c):
            st, x, acc = c
            s, ns = res_step(st, x)
            return ns, jnp.roll(x, 1, axis=-1), acc + s

        _scan_key(
            out, "cfg6_on_device_readouts_per_sec", pairs6,
            res_body, (st6, block6, jnp.float32(0.0)), k1=64, k2=4096,
        )

    print(json.dumps(out))


PROBE_CODE = (
    "import json, sys; sys.path.insert(0, sys.argv[1]);"
    "from signalizer_tpu.utils.device import device_stamp;"
    "print(json.dumps(device_stamp()))"
)


def _probe_device(timeout_s: float = 300.0) -> dict:
    """One check, in a child process (the parent stays off JAX), that a
    GPU is present. Returns the device stamp; raises RuntimeError when
    the child fails or JAX reports another platform. No retries."""
    proc = subprocess.run(
        [sys.executable, "-c", PROBE_CODE, str(Path(__file__).resolve().parent)],
        capture_output=True,
        text=True,
        timeout=timeout_s,
    )
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"device probe failed: {proc.stderr[-300:]}")
    stamp = json.loads(lines[-1])
    if stamp.get("platform") != "gpu":
        raise RuntimeError(f"no GPU found: JAX platform {stamp.get('platform')!r}")
    return stamp


def _cumulative_record(parts: dict, extra: dict) -> dict:
    """The driver-facing record: headline fields always present (zeros
    until the headline config lands), overlaid with every completed
    config's keys."""
    record = {
        "metric": "spectrum_frames_per_sec_per_chip_4096pt_stereo",
        "value": 0.0,
        "unit": "frames/s",
        "vs_baseline": 0.0,
    }
    record.update(parts)
    record.update(extra)
    return record


def _run_isolated(t_start: float, device: dict | None = None) -> None:
    """Run every config in its own child process, one after another, so
    one process holds the card at a time and a config that dies or
    hangs cannot take the others down.

    After EVERY config the cumulative record is printed as one flushed
    stdout line — each line a superset of the last — so a run killed at
    any point still leaves a parseable tail with everything measured so
    far. A total wall-clock budget (``SZ_BENCH_BUDGET_S``, default 900 s,
    probe included) skips remaining configs rather than being cut off
    mid-config; skipped and timed-out configs are named in the record.
    ``device`` (the probe's stamp) rides on every line. Partial results
    also persist to ``bench_partial.json`` for the multi-run aggregator."""
    budget = float(os.environ.get("SZ_BENCH_BUDGET_S", str(DEFAULT_BUDGET_S)))
    PARTIAL_PATH.unlink(missing_ok=True)
    parts = {}
    timed_out = []
    remaining_cfgs = list(CONFIG_NAMES)

    def emit():
        extra = dict(device or {})
        extra["elapsed_s"] = round(time.monotonic() - t_start, 1)
        if remaining_cfgs:
            extra["skipped_configs"] = list(remaining_cfgs)
        if timed_out:
            extra["timed_out_configs"] = list(timed_out)
        print(json.dumps(_cumulative_record(parts, extra)), flush=True)

    for cfg in CONFIG_NAMES:
        remaining_s = budget - (time.monotonic() - t_start)
        if remaining_s < 60.0:
            break
        remaining_cfgs.remove(cfg)
        try:
            proc = subprocess.run(
                [sys.executable, __file__, "--only", cfg],
                capture_output=True,
                text=True,
                timeout=min(1800.0, remaining_s),
            )
        except subprocess.TimeoutExpired:
            # one pathological config must not take the remaining
            # configs down with it
            sys.stderr.write(f"config {cfg} timed out\n")
            timed_out.append(cfg)
            emit()
            continue
        line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else "{}"
        try:
            parts.update(json.loads(line))
            _save_partial(parts)
        except json.JSONDecodeError:
            sys.stderr.write(f"config {cfg} failed: {proc.stderr[-500:]}\n")
        emit()
    _save_run(
        parts,
        {"skipped_configs": remaining_cfgs, "timed_out_configs": timed_out},
    )
    if "value" not in parts:
        raise RuntimeError("headline config failed")


def _error_line(e: Exception) -> None:
    """On failure still print ONE parseable JSON line, carrying any
    per-config results persisted before the failure."""
    record = {
        "metric": "spectrum_frames_per_sec_per_chip_4096pt_stereo",
        "value": 0.0,
        "unit": "frames/s",
        "vs_baseline": 0.0,
        "error": f"{type(e).__name__}: {e}"[:300],
    }
    partial = _load_partial()
    partial.update(record)  # error metadata wins on key clashes
    print(json.dumps(partial))


if __name__ == "__main__":
    if "--only" in sys.argv:
        main(sys.argv[sys.argv.index("--only") + 1])
    else:
        # a stale partial file from an earlier run must not be reported
        # as THIS run's numbers when the probe fails
        PARTIAL_PATH.unlink(missing_ok=True)
        t_start = time.monotonic()
        try:
            _run_isolated(t_start, _probe_device())
        except Exception as e:
            _error_line(e)
            raise SystemExit(1)
