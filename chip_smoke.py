#!/usr/bin/env python3
"""Smoke run of the analysis main path on the GPU, checked for parity.

    python chip_smoke.py                # phases A-D on one GPU
    python chip_smoke.py --four-cards   # phase E only, on four GPUs

Phases (one card):

* A — master-bus session: one ``SignalizerEngine`` + ``AnalysisSession``
  with all four views (stereo, 48 kHz, 48000-sample history, 4096-pt
  spectrum on 1024 axis points, zero-crossing/Lanczos oscilloscope at
  1920 px, Lissajous vectorscope, 16384-pt spectrogram), fed 3 s of
  audio as 256-sample packets and ticked every 800 samples (60 Hz).
* B — the same session loaded from the ``constantQ.spectrum`` factory
  preset, so the resonator (RSNT) spectrum runs through the session.
* C — the oscilloscope step at the cfg3 geometry: 16 pairs x 2 rows x
  8192 px from 16384-sample history at 96 kHz.
* D — the streaming spectrogram at the cfg4 geometry (16384-pt window,
  1024 axis points).

Phase E (``--four-cards``): ``ShardedAnalysisPipeline`` for the five
views plus ``sharded_resonator_step`` and ``sharded_mix_step`` over a
4-device mesh, compared with a 1-device mesh; every output must live on
all four devices.

Each phase compares its outputs with the same JAX step run on the CPU
device in this process, and its stages with the numpy oracles in
``tests/oracle.py`` (or the per-sample oracles below) where one exists.
The oscilloscope's waveform and envelope are held to the oracles only,
in each run: XLA's CPU backend evaluates the pixel positions
``start + p * step`` with a fused multiply-add and the GPU's does not, so
the two runs legitimately differ by one float32 rounding of a position.
Faults the session would contain (``protected_call``) are written to a
fresh exception log, which must stay empty; the fused all-views tick must
serve every eligible tick. Without a GPU the script exits non-zero before
any phase and prints no result. The last stdout line is one JSON object:
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

# --- parity bounds (reasons in CHANGES.md) -----------------------------------
DISPLAY_ATOL = 2e-3  # normalized display rows, clipped to the visible [0, 1]
U8_STEPS = 1  # spectrogram RGBA8 columns
OSC_REL = 1e-4  # oscilloscope waveform and envelope vs the oracles, times the peak
VS_ATOL = 1e-4  # vectorscope vertices and meters (times max(1, peak))
RES_ATOL = 2e-4  # resonator readout
SHARD_REL = 5e-4  # 4-device vs 1-device pipeline leaves, times max(1, peak)

PACKET = 256  # ref: ConcurrentConfig.h:41-43
TICK_SAMPLES = 800  # 60 Hz UI tick at 48 kHz


class SmokeFailure(AssertionError):
    pass


class Checks:
    """Collects named parity checks; any breach fails the run."""

    def __init__(self, out: Callable[[str], None] = print):
        self.out = out
        self.failures: list = []
        self.worst: dict = {}

    def bound(self, name: str, dev: float, limit: float) -> None:
        ok = bool(np.isfinite(dev)) and dev <= limit
        self.worst[name] = max(self.worst.get(name, 0.0), float(dev))
        if not ok:
            self.failures.append(f"{name}: {dev:.3e} > {limit:.1e}")
            self.out(f"FAIL {name}: max deviation {dev:.3e} (bound {limit:.1e})")

    def true(self, name: str, cond: bool, detail: str = "") -> None:
        if not cond:
            self.failures.append(f"{name} {detail}".strip())
            self.out(f"FAIL {name} {detail}".strip())

    def report(self, prefix: str) -> None:
        for name, dev in sorted(self.worst.items()):
            if name.startswith(prefix):
                self.out(f"  {name}: max deviation {dev:.3e}")

    def raise_if_failed(self, phase: str) -> None:
        if self.failures:
            raise SmokeFailure(f"phase {phase} failed: " + "; ".join(self.failures[:8]))


# --- comparison helpers --------------------------------------------------------


def u8_max_step(a, b) -> int:
    """Largest per-element difference of two uint8 images, in steps."""
    a = np.asarray(a, np.int16)
    b = np.asarray(b, np.int16)
    if a.shape != b.shape:
        raise SmokeFailure(f"shape mismatch {a.shape} vs {b.shape}")
    return int(np.max(np.abs(a - b))) if a.size else 0


def rel_to_peak(got, want) -> float:
    """max |got - want| over the reference's peak magnitude."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise SmokeFailure(f"shape mismatch {got.shape} vs {want.shape}")
    if not want.size:
        return 0.0
    if not np.all(np.isfinite(got)):
        return float("inf")
    return float(np.max(np.abs(got - want)) / max(float(np.max(np.abs(want))), 1e-30))


def abs_scaled(got, want) -> float:
    """max |got - want| over max(1, peak): absolute for unit-range data."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise SmokeFailure(f"shape mismatch {got.shape} vs {want.shape}")
    if not want.size:
        return 0.0
    if not np.all(np.isfinite(got)):
        return float("inf")
    return float(np.max(np.abs(got - want)) / max(float(np.max(np.abs(want))), 1.0))


def display_dev(got, want) -> float:
    """max |got - want| of normalized display rows as drawn: clipped to
    [0, 1]. Below the display floor the dB map log-amplifies leakage noise
    that no screen shows."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise SmokeFailure(f"shape mismatch {got.shape} vs {want.shape}")
    if not np.all(np.isfinite(got)):
        return float("inf")
    return float(np.max(np.abs(np.clip(got, 0, 1) - np.clip(want, 0, 1)))) if got.size else 0.0


# --- per-sample numpy oracles --------------------------------------------------


def resonator_oracle(poles, combine, gain, x) -> np.ndarray:
    """Per-sample complex one-pole bank z = c z + x, then the windowed
    readout |sum_v comb_v z_v| * gain (ref: resonateReal +
    getWholeWindowedState). poles [P, V] complex, x [N] -> [P]."""
    z = np.zeros(poles.shape, np.complex128)
    for s in np.asarray(x, np.float64):
        z = z * poles + s
    return np.abs(z @ np.asarray(combine, np.float64)) * np.asarray(gain, np.float64)


def zero_crossing_window_start(trig, threshold: float, window: float, lookahead: int) -> np.float32:
    """The displayed window's start in float32, from the per-sample trigger
    oracle: the newest fire in the lookahead whose following half window
    is complete (ref: StreamPreprocessing.h:78), the window centred on it
    and clamped into the history; with no such fire, the newest window.
    trig [H]."""
    from oracle import zero_crossing_oracle

    f32 = np.float32
    h = len(trig)
    la = min(lookahead, h)
    window = f32(min(window, h))
    fires = zero_crossing_oracle(trig[h - la :], threshold)
    complete = f32(h - la) + np.arange(la, dtype=f32) <= f32(h) - window * f32(0.5)
    cand = np.flatnonzero(fires & complete)
    if not cand.size:
        return f32(f32(h) - window)
    start = f32(h - la + cand[-1]) - (window - f32(1.0)) * f32(0.5)
    return f32(np.clip(start, f32(0.0), f32(h) - window))


def osc_frame_vs_oracle(constant, rows, frame: dict, window: float, env_os: int):
    """One zero-crossing, Lanczos, separate-rows oscilloscope frame against
    the oracles. The waveform is held to the per-tap resample and the
    envelope to the exact min and max of the samples each pixel spans, at
    the positions start + p * step that the trigger oracle gives. Those
    positions have two correctly rounded float32 evaluations (with or
    without a fused multiply-add, ``oracle.display_positions``); XLA's CPU
    backend fuses and the GPU's does not, so the whole frame is held to
    the one it fits best. rows [pairs, R, H] (the history), frame with
    waveform, envelope_min/max [pairs, R, P] and gain [pairs]. Returns
    (fused, waveform deviation, envelope deviation), over the peak."""
    from oracle import OSC_LANCZOS_A as a
    from oracle import display_positions, minmax_envelope_oracle, resample_oracle

    rows = np.asarray(rows, np.float32)
    pairs, nrows, h = rows.shape
    pixels = frame["waveform"].shape[-1]
    gain = np.asarray(frame["gain"], np.float64)[:, None, None]
    trig = rows[:, int(constant.trigger_channel) % nrows]
    start = np.array([zero_crossing_window_start(t, float(constant.threshold), window, constant.lookahead)
                      for t in trig], np.float32)
    step = np.full(pairs, (np.float32(min(window, h)) - np.float32(1.0)) / np.float32(max(pixels - 1, 1)))
    best = None
    for fused in (False, True):
        pos = np.clip(display_positions(start, step, pixels, fused), -(a + 1.0), h - 1.0 + a)
        wave_dev = rel_to_peak(frame["waveform"], resample_oracle(rows, pos[:, None], "lanczos", a) * gain)
        dense = display_positions(start, step / np.float32(env_os), pixels * env_os, fused)
        dense = np.clip(dense, -1.0, float(h)).reshape(pairs, 1, pixels, env_os)
        lo, hi = minmax_envelope_oracle(rows, dense[..., 0], dense[..., -1])
        env_dev = max(rel_to_peak(frame["envelope_min"], lo * gain), rel_to_peak(frame["envelope_max"], hi * gain))
        if best is None or max(wave_dev, env_dev) < max(best[1:]):
            best = (fused, wave_dev, env_dev)
    return best


def check_osc_frames(chk: Checks, name: str, constant, frames, window: float, env_os: int) -> str:
    """osc_frame_vs_oracle over (rows, frame) pairs; returns which
    position evaluation the frames fit, for the log."""
    from signalizer_tpu.core.config import OscChannels
    from signalizer_tpu.views.oscilloscope import SubSampleInterpolation, TriggerMode

    chk.true(f"{name}.osc_config", constant.trigger_mode == TriggerMode.ZERO_CROSSING
             and constant.interpolation == SubSampleInterpolation.LANCZOS
             and constant.channel_mode == OscChannels.SEPARATE)
    used = {False: 0, True: 0}
    for rows, frame in frames:
        fused, wave_dev, env_dev = osc_frame_vs_oracle(constant, rows, frame, window, env_os)
        used[fused] += 1
        chk.bound(f"{name}.osc_waveform_vs_oracle", wave_dev, OSC_REL)
        chk.bound(f"{name}.osc_envelope_vs_oracle", env_dev, OSC_REL)
    return f"{used[False]} frames unfused, {used[True]} fused"


def make_audio(n: int, sample_rate: float, seed: int, channels: int = 2) -> np.ndarray:
    """Deterministic program material: a few partials with slow vibrato,
    a little decorrelated noise, different per channel. [channels, n]."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sample_rate
    out = np.empty((channels, n), np.float32)
    for c in range(channels):
        f0 = 110.0 * 2 ** (rng.integers(0, 24) / 12.0)
        vib = 1.0 + 0.002 * np.sin(2 * np.pi * 5.0 * t)
        phase = 2 * np.pi * f0 * np.cumsum(vib) / sample_rate
        x = sum(0.3 / k * np.sin(k * phase + rng.uniform(0, 2 * np.pi)) for k in range(1, 6))
        x = x + 0.02 * rng.standard_normal(n)
        out[c] = x.astype(np.float32)
    return out


# --- devices, exception log ----------------------------------------------------


class Devices(NamedTuple):
    accel: object  # where the phase runs
    cpu: object  # the reference run


def exception_log_empty(path: Path) -> bool:
    return not path.exists() or path.stat().st_size == 0


def _tree_np(frame) -> dict:
    if frame is None:
        return {}
    return {k: np.asarray(v) for k, v in frame._asdict().items()}


# --- phase A / B: the session ---------------------------------------------------


def drive_session(
    device,
    audio: np.ndarray,
    *,
    preset: Optional[str] = None,
    axis_points: int = 1024,
    pixels: int = 1920,
    spectrum_window: int = 4096,
    spectrogram_window: int = 16384,
    history: int = 48_000,
):
    """Feed ``audio`` [2, n] through engine + session on ``device`` in
    256-sample packets, ticking every 800 samples. Returns (per-tick
    snapshots, info); each snapshot keeps the history the oscilloscope
    read, for its oracle."""
    import jax

    from signalizer_tpu.core.config import SpectrumChannels
    from signalizer_tpu.engine import SignalizerEngine
    from signalizer_tpu.session import AnalysisSession
    from signalizer_tpu.stream.audio_stream import Playhead
    from signalizer_tpu.views.oscilloscope import SubSampleInterpolation, TriggerMode

    ticks = []
    with jax.default_device(device):
        eng = SignalizerEngine("chip-smoke", history_capacity=history, load_default_preset=False)
        osc = eng.oscilloscope
        osc.trigger_mode.set_transformed(int(TriggerMode.ZERO_CROSSING))
        osc.sub_sample_interpolation.set_transformed(int(SubSampleInterpolation.LANCZOS))
        osc.channel_configuration.set_transformed(4)  # separate: both channels drawn
        eng.vectorscope.operational_mode.set_transformed(0)  # lissajous
        sp = eng.spectrum
        sp.channel_configuration.set_transformed(int(SpectrumChannels.SEPARATE))
        sp.bin_interpolation.set_transformed(1)  # linear, the headline geometry
        if preset is not None and not eng.load_preset(preset):
            raise SmokeFailure(f"factory preset {preset!r} did not load")
        # the spectrogram runs at its own (longer) window: build it at that
        # knob value, then restore the line-graph spectrum's window
        keep = sp.window_size.get_transformed()
        sp.window_size.set_transformed(spectrogram_window)
        sess = AnalysisSession(eng, axis_points=axis_points, pixels=pixels)
        if preset is None:
            sp.window_size.set_transformed(spectrum_window)
        else:
            sp.window_size.set_transformed(keep)
        sess.reconfigure("spectrum")
        oproc = sess.processor("oscilloscope")
        osc_window = float(oproc.effective_window_samples(sync_device=False))
        osc_h = sess._osc_history_len()  # the history the oscilloscope reads
        t0 = time.perf_counter()
        since = 0
        tick_s = []
        for start in range(0, audio.shape[1], PACKET):
            blk = audio[:, start : start + PACKET]
            sess.feed(blk, Playhead(steady_clock=start + blk.shape[1], bpm=120.0, is_playing=True))
            since += blk.shape[1]
            if since >= TICK_SAMPLES:
                since -= TICK_SAMPLES
                osc_hist = np.asarray(eng.get_presentation_history(osc_h), np.float32)[None, :2]
                ta = time.perf_counter()
                fr = sess.tick()
                snap = {
                    "spectrum": None if fr.spectrum is None else np.asarray(fr.spectrum),
                    "osc": _tree_np(fr.oscilloscope),
                    "vs": _tree_np(fr.vectorscope),
                    "cols": None if fr.spectrogram_columns is None else np.asarray(fr.spectrogram_columns),
                    "line_graph": fr.line_graph is not None,
                    "osc_hist": osc_hist,
                }
                tick_s.append(time.perf_counter() - ta)
                ticks.append(snap)
        info = {
            "wall_s": time.perf_counter() - t0,
            "tick_p50_ms": float(np.median(tick_s) * 1e3) if tick_s else 0.0,
            "fused": sess.fused_tick_count,
            "spectrum_proc": sess.processor("spectrum"),
            "osc_proc": oproc,
            "osc_window": osc_window,
            "osc_env_os": oproc._prep_step(osc_h, 0.0, 1)[4],
            "history": eng.get_presentation_history(
                min(history, max(spectrogram_window, spectrum_window, 16384))
            ),
            "sample_rate": eng.config.sample_rate,
        }
        sess.close()
    return ticks, info


def compare_sessions(chk: Checks, phase: str, got, want) -> None:
    chk.true(f"{phase}.tick_count", len(got) == len(want), f"{len(got)} vs {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        for key in ("spectrum", "cols"):
            chk.true(f"{phase}.{key}_presence", (g[key] is None) == (w[key] is None), f"tick {i}")
        chk.true(f"{phase}.line_graph", g["line_graph"] == w["line_graph"], f"tick {i}")
        if g["spectrum"] is not None and w["spectrum"] is not None:
            bound = RES_ATOL if phase == "B" else DISPLAY_ATOL
            chk.bound(f"{phase}.spectrum_display", display_dev(g["spectrum"], w["spectrum"]), bound)
        if g["cols"] is not None and w["cols"] is not None:
            chk.bound(f"{phase}.spectrogram_rgba8_steps", u8_max_step(g["cols"], w["cols"]), U8_STEPS)
        # waveform and envelope: each run against the oracle (phase_session)
        if "gain" in w["osc"]:
            chk.bound(f"{phase}.osc_gain", rel_to_peak(g["osc"]["gain"], w["osc"]["gain"]), OSC_REL)
        if "colours" in w["osc"]:
            chk.bound(f"{phase}.osc_colours", abs_scaled(g["osc"]["colours"], w["osc"]["colours"]), OSC_REL)
        if "trigger_found" in w["osc"]:
            chk.true(
                f"{phase}.osc_trigger_found",
                np.array_equal(g["osc"]["trigger_found"], w["osc"]["trigger_found"]),
                f"tick {i}",
            )
        for key in ("vertices", "balance", "correlation_bars", "gain"):
            if key in w["vs"]:
                chk.bound(f"{phase}.vs_{key}", abs_scaled(g["vs"][key], w["vs"][key]), VS_ATOL)


def _scalar(x) -> float:
    return float(np.ravel(np.asarray(x))[0])


def spectrum_oracle_check(chk: Checks, phase: str, device, constant, frames) -> None:
    """One T=1 analysis on ``device`` (fresh decay state: the result is the
    dB-mapped spectrum itself) against the per-pixel numpy oracle."""
    import jax
    import jax.numpy as jnp

    from oracle import db_map_oracle, spectrum_values_oracle
    from signalizer_tpu.core.constant import host_view
    from signalizer_tpu.kernels.spectrum import analyze_frames, init_line_graph_state

    names = {0: "left", 1: "right", 2: "merge", 3: "side", 4: "phase", 5: "separate", 6: "midside", 7: "complex"}
    interp = {0: "none", 1: "linear", 2: "lanczos"}
    frames = np.asarray(frames, np.float32)  # [2, W]
    with jax.default_device(device):
        res = analyze_frames(constant, init_line_graph_state(constant), jnp.asarray(frames[None]))
        got = np.asarray(res.results)[0, 0]  # [rows, P] of graph 0
    w = constant.window_size
    vals = spectrum_values_oracle(
        frames.astype(np.float64),
        config=names[int(constant.configuration)],
        window=host_view(constant, "window_kernel"),
        window_scale=_scalar(host_view(constant, "inv_size")) * w * 0.5,
        mapped_frequencies=host_view(constant, "mapped_frequencies"),
        sample_rate=constant.sample_rate,
        transform_size=constant.transform_size,
        interpolation=interp[int(constant.bin_interpolation)],
    )
    want = db_map_oracle(
        vals,
        host_view(constant, "slope_map"),
        _scalar(host_view(constant, "low_dbs")),
        _scalar(host_view(constant, "high_dbs")),
        _scalar(constant.clip_db),
    )
    chk.bound(f"{phase}.spectrum_vs_oracle", display_dev(got, want), DISPLAY_ATOL)


def osc_oracle_checks(chk: Checks, phase: str, device, rows, window: float, pixels: int,
                      lookahead: int, seed: int) -> None:
    """Trigger fire marks (exact) and the Lanczos resample alone (relative
    to the peak, at the evaluation of its positions that it fits) on
    ``device`` against the per-sample numpy oracles. rows [pairs, R, H]."""
    import jax
    import jax.numpy as jnp

    from oracle import display_positions, resample_oracle, zero_crossing_oracle
    from signalizer_tpu.kernels.oscilloscope import (
        INTERPOLATION_KERNEL_SIZE,
        sinc_resample,
        zero_crossing_triggers,
    )

    rows = np.asarray(rows, np.float32)
    pairs, _, h = rows.shape
    la = min(lookahead, h)
    region = rows[:, 0, h - la :]
    rng = np.random.default_rng(seed)
    start = rng.uniform(0.0, h - window, (pairs, 1)).astype(np.float32)
    step = np.full((pairs, 1), (window - 1.0) / max(pixels - 1, 1), np.float32)
    with jax.default_device(device):
        for thr in (0.0, 0.1):
            fires = np.asarray(jax.jit(zero_crossing_triggers, static_argnums=1)(jnp.asarray(region), thr))
            want = np.stack([zero_crossing_oracle(r, thr) for r in region])
            chk.true(f"{phase}.trigger_fires_exact", np.array_equal(fires, want),
                     f"threshold {thr}: {int(np.sum(fires != want))} marks differ")
        wave = np.asarray(jax.jit(sinc_resample, static_argnums=3)(
            jnp.asarray(rows), jnp.asarray(start), jnp.asarray(step), pixels))
    a = INTERPOLATION_KERNEL_SIZE
    dev = min(rel_to_peak(wave, resample_oracle(
        rows, np.clip(display_positions(start, step, pixels, fused), -(a + 1.0), h - 1.0 + a), "lanczos", a))
        for fused in (False, True))
    chk.bound(f"{phase}.resample_vs_oracle", dev, OSC_REL)


def resonator_oracle_check(chk: Checks, phase: str, device, res, x) -> None:
    """One block of the resonator bank on ``device`` from zero state
    against the per-sample complex recurrence in float64."""
    import jax
    import jax.numpy as jnp

    from signalizer_tpu.kernels.resonator import (
        init_resonator_state,
        make_block_plan,
        resonate_block,
        resonator_readout,
    )

    with jax.default_device(device):
        st = resonate_block(res, init_resonator_state(res), jnp.asarray(x), make_block_plan(res, len(x)))
        got = np.asarray(resonator_readout(res, st))
    want = resonator_oracle(res.host_poles.array(), np.asarray(res.combine), np.asarray(res.gain), x)
    chk.bound(f"{phase}.resonator_vs_oracle", abs_scaled(got, want), RES_ATOL)


def lissajous_oracle_check(chk: Checks, phase: str, device, window) -> None:
    """Lissajous vertices on ``device``: x = right, y = left
    (ref: VectorscopeRendering.cpp:466)."""
    import jax
    import jax.numpy as jnp

    from signalizer_tpu.kernels.vectorscope import lissajous_vertices

    with jax.default_device(device):
        v = np.asarray(lissajous_vertices(jnp.asarray(window)))
    chk.bound(f"{phase}.lissajous_vs_oracle",
              abs_scaled(v[:, :2], np.stack([window[1], window[0]], -1)), VS_ATOL)


def phase_session(devs: Devices, chk: Checks, *, preset: Optional[str] = None, seconds: float = 3.0,
                  out=print, **geometry) -> dict:
    """Phase A (``preset=None``) or B (a factory preset). ``geometry``
    overrides drive_session's sizes (tests run it tiny)."""
    from signalizer_tpu.views.spectrum import ResonatorSpectrumProcessor

    phase = "A" if preset is None else "B"
    sr = 48_000.0
    audio = make_audio(int(seconds * sr), sr, seed=1 if preset is None else 2)
    got, info = drive_session(devs.accel, audio, preset=preset, **geometry)
    want, _ = drive_session(devs.cpu, audio, preset=preset, **geometry)
    n_ticks = len(got)
    chk.true(f"{phase}.ticks_ran", n_ticks >= max(1, int(seconds * 60) - 2), f"{n_ticks} ticks")
    fresh = [t for t in got if t["spectrum"] is not None]
    chk.true(f"{phase}.all_views", all(t["osc"] and t["vs"] and t["cols"] is not None for t in got))
    chk.true(f"{phase}.spectrum_served", len(fresh) >= n_ticks - 2, f"{len(fresh)}/{n_ticks}")
    compare_sessions(chk, phase, got, want)
    oc = info["osc_proc"].constant
    fits = {name: check_osc_frames(chk, phase, oc, [(t["osc_hist"], t["osc"]) for t in run if t["osc"]],
                                   info["osc_window"], info["osc_env_os"])
            for name, run in (("device", got), ("cpu", want))}

    proc = info["spectrum_proc"]
    hist = np.asarray(info["history"], np.float32)
    if isinstance(proc, ResonatorSpectrumProcessor):
        resonator_oracle_check(chk, phase, devs.accel, proc.resonator, hist[0, -2048:])
    else:
        # the fused all-views step must have served every tick (the per-view
        # fallback also catches protected failures of the fused step)
        chk.true(f"{phase}.fused_every_tick", info["fused"] == n_ticks,
                 f"fused {info['fused']} of {n_ticks} ticks")
        c = proc.constant
        spectrum_oracle_check(chk, phase, devs.accel, c, hist[:2, -c.window_size:])
        osc_oracle_checks(chk, phase, devs.accel, hist[None, :2, -16384:],
                          window=min(960.0, hist.shape[-1] / 2), pixels=info["osc_proc"].pixels,
                          lookahead=8192, seed=3)
        lissajous_oracle_check(chk, phase, devs.accel, hist[:2, -4096:])
    out(f"phase {phase}: {n_ticks} ticks, fused {info['fused']}, host tick p50 "
        f"{info['tick_p50_ms']:.3f} ms, wall {info['wall_s']:.1f} s; oscilloscope positions: "
        f"device {fits['device']}, cpu {fits['cpu']}")
    return {"ticks": n_ticks, "fused": info["fused"]}


# --- phase C: oscilloscope at cfg3 ------------------------------------------------


def phase_osc(devs: Devices, chk: Checks, *, pairs: int = 16, pixels: int = 8192, history: int = 16384,
              window: float = 1024.0, sample_rate: float = 96_000.0, lookahead: int = 8192,
              steps: int = 3, out=print) -> dict:
    import jax

    from signalizer_tpu.core.config import OscChannels
    from signalizer_tpu.views.oscilloscope import (
        OscilloscopeProcessor,
        SubSampleInterpolation,
        TriggerMode,
    )

    hop = 1024
    audio = np.stack([make_audio(history + steps * hop, sample_rate, seed=10 + p) for p in range(pairs)])

    def run(device):
        frames = []
        with jax.default_device(device):
            proc = OscilloscopeProcessor(
                pairs=pairs, sample_rate=sample_rate, channel_mode=OscChannels.SEPARATE,
                trigger_mode=TriggerMode.ZERO_CROSSING,
                interpolation=SubSampleInterpolation.LANCZOS, window_samples=window,
                pixels=pixels, lookahead=lookahead, trigger_threshold=0.1, autogain=True,
            )
            t0 = time.perf_counter()
            for s in range(steps):
                hist = audio[:, :, (s + 1) * hop : (s + 1) * hop + history]
                frames.append((hist, _tree_np(proc.process(hist, new_samples=hop))))
            return frames, time.perf_counter() - t0, proc

    got, wall, proc = run(devs.accel)
    want, _, _ = run(devs.cpu)
    env_os = proc._prep_step(history, 0.0, hop)[4]
    fits = {name: check_osc_frames(chk, "C", proc.constant, frames, window, env_os)
            for name, frames in (("device", got), ("cpu", want))}
    for (_, g), (_, w) in zip(got, want):
        chk.bound("C.osc_gain", rel_to_peak(g["gain"], w["gain"]), OSC_REL)
        chk.true("C.trigger_found", np.array_equal(g["trigger_found"], w["trigger_found"]))
        chk.true("C.shape", g["waveform"].shape == (pairs, 2, pixels), str(g["waveform"].shape))
    last = audio[:, :, steps * hop : steps * hop + history]
    osc_oracle_checks(chk, "C", devs.accel, last, window=window, pixels=pixels,
                      lookahead=lookahead, seed=4)
    out(f"phase C: {steps} steps of {pairs} pairs x 2 rows x {pixels} px, wall {wall:.2f} s; "
        f"positions: device {fits['device']}, cpu {fits['cpu']}")
    return {"steps": steps}


# --- phase D: streaming spectrogram at cfg4 -------------------------------------


def phase_spectrogram(devs: Devices, chk: Checks, *, window: int = 16384, axis_points: int = 1024,
                      seconds: float = 3.0, blob_ms: float = 10.0, out=print) -> dict:
    import jax

    from signalizer_tpu.core.config import BinInterpolation, DisplayMode, SpectrumChannels, ViewScaling
    from signalizer_tpu.core.constant import make_spectrum_constant
    from signalizer_tpu.views.spectrogram import SpectrogramProcessor

    sr = 48_000.0
    audio = make_audio(window + int(seconds * sr), sr, seed=20)

    def run(device):
        with jax.default_device(device):
            c = make_spectrum_constant(
                axis_points=axis_points, window_size=window, sample_rate=sr,
                configuration=SpectrumChannels.LEFT, bin_interpolation=BinInterpolation.LINEAR,
                view_scaling=ViewScaling.LOGARITHMIC, display_mode=DisplayMode.COLOUR_SPECTRUM,
            )
            sp = SpectrogramProcessor(c, pairs=1, blob_ms=blob_ms)
            cols, since = [], 0
            t0 = time.perf_counter()
            for start in range(0, audio.shape[1], PACKET):
                blk = audio[:, start : start + PACKET]
                sp.push(blk)
                since += blk.shape[1]
                if since >= TICK_SAMPLES:
                    since -= TICK_SAMPLES
                    cols.append(np.asarray(sp.pull()))
            cols.append(np.asarray(sp.pull()))
            return np.concatenate(cols), c, time.perf_counter() - t0

    got, constant, wall = run(devs.accel)
    want, _, _ = run(devs.cpu)
    chk.true("D.columns", got.shape == want.shape and got.shape[0] > 0, f"{got.shape} vs {want.shape}")
    if got.shape == want.shape:
        chk.bound("D.spectrogram_rgba8_steps", u8_max_step(got, want), U8_STEPS)
    spectrum_oracle_check(chk, "D", devs.accel, constant, audio[:, -window:])
    out(f"phase D: {got.shape[0]} columns of {axis_points} px from a {window}-pt window, wall {wall:.2f} s")
    return {"columns": int(got.shape[0])}


# --- phase E: four cards ---------------------------------------------------------


def phase_four_cards(chk: Checks, *, n_devices: int = 4, pairs: int = 8, window: int = 4096,
                     history: int = 48_000, pixels: int = 1920, ticks: int = 4, out=print) -> dict:
    import jax
    import jax.numpy as jnp

    from signalizer_tpu.core.config import (
        BinInterpolation,
        OscChannels,
        SpectrumChannels,
        TransformAlgorithm,
        ViewScaling,
    )
    from signalizer_tpu.core.constant import make_spectrum_constant
    from signalizer_tpu.parallel.mesh import (
        make_analysis_mesh,
        shard_batch,
        sharded_mix_step,
        sharded_resonator_step,
    )
    from signalizer_tpu.parallel.pipeline import ShardedAnalysisPipeline
    from signalizer_tpu.views.oscilloscope import TriggerMode, make_oscilloscope_constant
    from signalizer_tpu.views.spectrum import ResonatorSpectrumProcessor

    def on_all(tree, name):
        for leaf in jax.tree_util.tree_leaves(tree):
            if hasattr(leaf, "sharding"):
                n = len(leaf.sharding.device_set)
                chk.true(f"E.{name}.device_set", n == n_devices, f"{n} devices")

    def compare(name, multi, single):
        for lm, ls in zip(jax.tree_util.tree_leaves(multi), jax.tree_util.tree_leaves(single)):
            a, b = np.asarray(lm), np.asarray(ls)
            if a.dtype == np.uint8:
                chk.bound(f"E.{name}.rgba8_steps", u8_max_step(a, b), U8_STEPS)
            elif a.dtype == np.bool_:
                chk.true(f"E.{name}.bool", np.array_equal(a, b))
            else:
                chk.bound(f"E.{name}", abs_scaled(a, b), SHARD_REL)

    mesh = make_analysis_mesh(n_devices)
    mesh1 = make_analysis_mesh(1)
    constant = make_spectrum_constant(
        axis_points=1024, window_size=window, sample_rate=48_000.0,
        configuration=SpectrumChannels.SEPARATE, bin_interpolation=BinInterpolation.LINEAR,
        view_scaling=ViewScaling.LOGARITHMIC,
    )
    oc = make_oscilloscope_constant(
        channel_mode=OscChannels.SEPARATE, trigger_mode=TriggerMode.ZERO_CROSSING,
        pixels=pixels, lookahead=8192, trigger_threshold=0.1, autogain=True,
    )
    audio = np.stack([make_audio(ticks * 2 * window, 48_000.0, seed=30 + c, channels=1)[0]
                      for c in range(pairs * 2)])
    t0 = time.perf_counter()
    for view in ("fused", "spectrum", "spectrogram", "oscilloscope", "vectorscope"):
        kwargs = dict(pairs=pairs, view=view, pixels=pixels, frames_per_tick=2,
                      window_samples=1024.0, history_samples=history)
        if view in ("fused", "spectrum", "spectrogram"):
            kwargs["constant"] = constant
        if view == "oscilloscope":
            kwargs["osc_constant"] = oc
        multi = ShardedAnalysisPipeline(mesh=mesh, **kwargs)
        single = ShardedAnalysisPipeline(mesh=mesh1, **kwargs)
        ran = 0
        for i in range(ticks):
            block = audio[:, i * 2 * window : (i + 1) * 2 * window]
            multi.push(block)
            single.push(block)
            om, os_ = multi.tick(), single.tick()
            chk.true(f"E.{view}.ready", (om is None) == (os_ is None))
            if om is None:
                continue
            ran += 1
            on_all(om, view)
            compare(view, om, os_)
        chk.true(f"E.{view}.ticks", ran >= ticks - 1, f"{ran} ticks")

    rs_constant = make_spectrum_constant(
        axis_points=1024, window_size=window, configuration=SpectrumChannels.SEPARATE,
        algo=TransformAlgorithm.RESONATOR,
    )
    rng = np.random.default_rng(31)
    blocks = (0.3 * rng.standard_normal((pairs, 2, 2, 1024))).astype(np.float32)
    valid = np.ones(2, bool)
    ref = ResonatorSpectrumProcessor(rs_constant, pairs=pairs)
    want = np.asarray(ref.process_chunks(blocks, valid))
    sh = ResonatorSpectrumProcessor(rs_constant, pairs=pairs)
    step = sharded_resonator_step(rs_constant, sh.resonator, sh.block_plan(1024), mesh)
    rs_out, rs_state, _, _ = step(
        shard_batch(sh.res_state, mesh), shard_batch(sh.graph_state, mesh),
        shard_batch(jnp.asarray(blocks), mesh), jnp.asarray(valid),
    )
    on_all((rs_out, rs_state), "resonator")
    chk.bound("E.resonator", display_dev(np.asarray(rs_out), want), RES_ATOL)

    sources = n_devices * 2
    src = rng.standard_normal((sources, 2, 4096)).astype(np.float32)
    routing = np.zeros((sources, 2, 16), np.float32)
    routing[:, 0, 0] = 1.0
    routing[:, 1, 1] = 1.0
    mixed, _ = sharded_mix_step(mesh)(shard_batch(jnp.asarray(src), mesh), shard_batch(jnp.asarray(routing), mesh))
    on_all(mixed, "mix")
    want_mix = np.zeros((16, 4096))
    want_mix[0] = src[:, 0].sum(0)
    want_mix[1] = src[:, 1].sum(0)
    chk.bound("E.mix", abs_scaled(np.asarray(mixed), want_mix), SHARD_REL)
    out(f"phase E: {n_devices}-device mesh vs 1 device, {pairs} pairs, wall {time.perf_counter() - t0:.1f} s")
    return {}


# --- entry ----------------------------------------------------------------------


def _backends():
    """Bring up the accelerator and the CPU backend before any computation;
    returns (jax.devices(), the CPU device)."""
    import jax

    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        jax.config.update("jax_platforms", plats + ",cpu")
    return jax.devices(), jax.devices("cpu")[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run phase E (the sharded pipeline on four GPUs) and nothing else")
    args = ap.parse_args(argv)

    devices, cpu = _backends()
    platform = devices[0].platform
    if platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform {platform!r}); nothing was run", file=sys.stderr)
        return 2
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, JAX sees {len(devices)}", file=sys.stderr)
        return 2

    import jax

    from signalizer_tpu import native_bindings
    from signalizer_tpu.utils.device import enable_compile_cache, query_nvidia_smi
    from signalizer_tpu.utils.exception_log import set_exception_log_path

    cache = enable_compile_cache()
    raw, _cards = query_nvidia_smi()
    for line in raw.splitlines()[:need]:
        print(line)
    print(f"jax {jax.__version__}; device kind {devices[0].device_kind!r} x {len(devices)}; compile cache {cache}")
    print(f"host ring backend: {'native' if native_bindings.native_available() else 'numpy'}"
          + ("" if native_bindings.native_available() else f" ({native_bindings.native_build_error()})"))
    print("spectrum FFT: jnp.fft (cuFFT) in float32; recurrence and resample products at Precision.HIGHEST")

    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-"))
    log_path = tmp / "exceptions.log"
    log_path.touch()
    set_exception_log_path(log_path)
    chk = Checks()
    devs = Devices(accel=devices[0], cpu=cpu)
    try:
        if args.four_cards:
            phases = [("E", lambda: phase_four_cards(chk))]
        else:
            phases = [
                ("A", lambda: phase_session(devs, chk)),
                ("B", lambda: phase_session(devs, chk, preset="constantQ.spectrum")),
                ("C", lambda: phase_osc(devs, chk)),
                ("D", lambda: phase_spectrogram(devs, chk)),
            ]
        for name, run in phases:
            run()
            chk.true(f"{name}.exception_log_empty", exception_log_empty(log_path),
                     log_path.read_text()[-2000:] if log_path.exists() else "")
            chk.report(f"{name}.")
            chk.raise_if_failed(name)
    except Exception as e:  # every failure ends the run without a result line
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devices[0].device_kind, "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
