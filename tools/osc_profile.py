"""On-device ablation profile of the oscilloscope step (cfg3 geometry).

Times each component of osc_step_impl by scan-chain slope (scalar-
checksum sync — see bench.py) to find where the step's device time goes:

    python tools/osc_profile.py
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np


def main() -> int:
    import functools

    import jax
    import jax.numpy as jnp
    from jax import lax

    from signalizer_tpu.utils.device import enable_compile_cache

    enable_compile_cache()

    from signalizer_tpu.core.config import OscChannels
    from signalizer_tpu.kernels.oscilloscope import (
        minmax_decimate,
        sinc_resample,
        zero_crossing_triggers,
    )
    from signalizer_tpu.views.oscilloscope import (
        OscilloscopeProcessor,
        SubSampleInterpolation,
        TriggerMode,
        osc_step_impl,
    )

    print(f"device: {jax.devices()[0]}", flush=True)

    def scan_rate(body, init_carry, k1=8, k2=64, reps=5):
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

        return max((med(k2) - med(k1)) / (k2 - k1), 1e-9)

    # cfg3 geometry
    pairs, h, pixels = 16, 16384, 8192
    rng = np.random.default_rng(0)
    t = np.arange(h)
    hist = np.sin(2 * np.pi * 440.0 * t / 96_000.0).astype(np.float32)
    hist_dev = jnp.asarray(np.broadcast_to(hist, (pairs, 2, h)).copy())
    rows = hist_dev  # SEPARATE mode: rows == channels
    start = jnp.asarray(rng.uniform(0, h - 1100, (pairs, 1)).astype(np.float32))
    step = jnp.full((pairs, 1), 1023.0 / (pixels - 1), jnp.float32)

    def report(name, body, carry):
        dt = scan_rate(body, carry)
        print(f"{name:38s} {dt * 1e3:8.3f} ms/step", flush=True)
        return dt

    # 1. full ZC step
    osc = OscilloscopeProcessor(
        pairs=pairs, sample_rate=96_000.0, channel_mode=OscChannels.SEPARATE,
        trigger_mode=TriggerMode.ZERO_CROSSING,
        interpolation=SubSampleInterpolation.LANCZOS,
        window_samples=1024.0, pixels=pixels, lookahead=8192,
        trigger_threshold=0.1, autogain=True,
    )
    win = jnp.float32(1024.0)

    def full_body(c):
        st, x, acc = c
        fr, nst = osc_step_impl(
            osc.constant, st, x, win, jnp.float32(0.0), jnp.float32(h), None
        )
        return nst, jnp.roll(x, 1, axis=-1), acc + jnp.sum(fr.waveform) + jnp.sum(fr.envelope_max)

    report("full ZC step", full_body, (osc.state, hist_dev, jnp.float32(0.0)))

    # 1b. full ZC step with the production env_os hint (window 1024 over
    # 8192 px is upsampling -> hint 1 vs the conservative ceil(h/px)=2)
    def full_body_hint(c):
        st, x, acc = c
        fr, nst = osc_step_impl(
            osc.constant, st, x, win, jnp.float32(0.0), jnp.float32(h), None,
            env_os=1,
        )
        return nst, jnp.roll(x, 1, axis=-1), acc + jnp.sum(fr.waveform) + jnp.sum(fr.envelope_max)

    report("full ZC step (env_os hint)", full_body_hint,
           (osc.state, hist_dev, jnp.float32(0.0)))

    # 2. step with NONE interpolation (nearest) — resample ablation
    osc_n = OscilloscopeProcessor(
        pairs=pairs, sample_rate=96_000.0, channel_mode=OscChannels.SEPARATE,
        trigger_mode=TriggerMode.ZERO_CROSSING,
        interpolation=SubSampleInterpolation.NONE,
        window_samples=1024.0, pixels=pixels, lookahead=8192,
        trigger_threshold=0.1, autogain=True,
    )

    def none_body(c):
        st, x, acc = c
        fr, nst = osc_step_impl(
            osc_n.constant, st, x, win, jnp.float32(0.0), jnp.float32(h), None
        )
        return nst, jnp.roll(x, 1, axis=-1), acc + jnp.sum(fr.waveform) + jnp.sum(fr.envelope_max)

    report("step w/ nearest interp", none_body, (osc_n.state, hist_dev, jnp.float32(0.0)))

    # 3. sinc resample alone (lanczos, a=10)
    def sinc_body(c):
        x, s, acc = c
        w = sinc_resample(x, s, step, pixels, 10)
        return jnp.roll(x, 1, axis=-1), jnp.mod(s + 1.0, 8000.0), acc + jnp.sum(w)

    report("sinc_resample alone", sinc_body, (rows, start, jnp.float32(0.0)))

    # 4. ZC trigger alone
    def trig_body(c):
        x, acc = c
        fires = zero_crossing_triggers(x[:, 0, :], 0.1)
        last = jnp.max(jnp.where(fires, jnp.arange(h, dtype=jnp.float32), -1.0), axis=-1)
        return jnp.roll(x, 1, axis=-1), acc + jnp.sum(last)

    report("ZC trigger alone (16k)", trig_body, (hist_dev, jnp.float32(0.0)))

    # 5. minmax decimate alone
    def mm_body(c):
        x, acc = c
        lo, hi = minmax_decimate(x, pixels)
        return jnp.roll(x, 1, axis=-1), acc + jnp.sum(lo) + jnp.sum(hi)

    report("minmax_decimate alone", mm_body, (hist_dev, jnp.float32(0.0)))

    return 0


if __name__ == "__main__":
    sys.exit(main())
