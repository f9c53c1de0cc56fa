"""Production session-tick profile: device-resident history ON vs OFF.

Measures `AnalysisSession.tick` — the real editor/embedding drive path —
with the shared device history ring (stream/device_history.py, hop-only
uploads) against the host-path fallback (full window re-upload per view
per tick). Same audio, same views, alternating fresh sessions.

Outputs are synced on a scalar checksum folded from the tick's arrays;
the feed is advanced every tick so no window is constant; medians over
many ticks after a warmup that compiles every pow2 upload bucket the
cadence hits.

Run:  python tools/session_profile.py            (ambient platform)
      SIGNALIZER_TPU_PROFILE_TICKS=200 python tools/session_profile.py
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    import jax

    from signalizer_tpu.utils.device import enable_compile_cache

    enable_compile_cache()

    from signalizer_tpu.engine import SignalizerEngine
    from signalizer_tpu.session import AnalysisSession
    from signalizer_tpu.stream.audio_stream import Playhead

    ticks = int(os.environ.get("SIGNALIZER_TPU_PROFILE_TICKS", "120"))
    warm = 24
    fs = 48_000.0
    block = 800  # UI-cadence hop: 60 Hz of 48 kHz audio per tick
    views = ("spectrum", "oscilloscope", "vectorscope")

    def checksum(frame) -> float:
        # scalar sync: touch every produced array (device outputs resolve)
        acc = 0.0
        if frame.spectrum is not None:
            acc += float(np.sum(np.asarray(frame.spectrum)))
        if frame.oscilloscope is not None:
            acc += float(np.sum(np.asarray(frame.oscilloscope.waveform)))
        if frame.vectorscope is not None:
            acc += float(np.sum(np.asarray(frame.vectorscope.vertices)))
        return acc

    out = {"device": str(jax.devices()[0]), "ticks": ticks, "block": block}
    rng = np.random.default_rng(0)
    for device_history in (True, False):
        eng = SignalizerEngine("profile", load_default_preset=False)
        sess = AnalysisSession(
            eng,
            views=views,
            axis_points=1024,
            pixels=1024,
            device_history=device_history,
        )
        t_samples = 0
        acc = 0.0
        times = []
        for i in range(warm + ticks):
            t = (t_samples + np.arange(block)) / fs
            x = (
                0.5 * np.sin(2 * np.pi * 440.0 * t)
                + 0.1 * rng.standard_normal(block)
            ).astype(np.float32)
            t_samples += block
            sess.feed(
                np.stack([x, 0.8 * x]),
                Playhead(steady_clock=t_samples, bpm=120.0, is_playing=True),
            )
            t0 = time.perf_counter()
            frame = sess.tick()
            acc += checksum(frame)  # sync inside the timed region
            if i >= warm:
                times.append(time.perf_counter() - t0)
        key = "device" if device_history else "host"
        out[f"tick_p50_ms_{key}"] = round(float(np.median(times)) * 1e3, 4)
        out[f"tick_p99_ms_{key}"] = round(
            float(np.percentile(times, 99)) * 1e3, 4
        )
        print(
            f"  {key}: p50 {out[f'tick_p50_ms_{key}']} ms "
            f"p99 {out[f'tick_p99_ms_{key}']} ms (checksum {acc:.3f})",
            file=sys.stderr,
        )
        sess.close()
    if out.get("tick_p50_ms_host"):
        out["speedup_p50"] = round(
            out["tick_p50_ms_host"] / max(out["tick_p50_ms_device"], 1e-9), 3
        )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
