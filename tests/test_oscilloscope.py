"""Oscilloscope kernels vs naive oracles + end-to-end trigger behavior."""

import numpy as np
import jax.numpy as jnp
import pytest

from oracle import display_positions, resample_oracle, zero_crossing_oracle
from signalizer_tpu.core.config import OscChannels
from signalizer_tpu.kernels.oscilloscope import (
    goertzel,
    last_zero_crossing_trigger,
    minmax_decimate,
    peak_hold_triggers,
    sinc_resample,
    linear_resample,
    spectral_fundamental,
    zero_crossing_triggers,
)
from signalizer_tpu.views.oscilloscope import (
    OscilloscopeProcessor,
    SubSampleInterpolation,
    TriggerMode,
)

FS = 48_000.0


# ---------------------------------------------------------------------------
# trigger oracles (naive per-sample state machines from the reference
# semantics, StreamPreprocessing.h:270-349; the zero-crossing one lives in
# tests/oracle.py)
# ---------------------------------------------------------------------------


def _peak_hold_oracle(x, threshold, hysteresis, decay=0.9999):
    fires = np.zeros(len(x), bool)
    state = threshold * threshold
    holding = False
    for i, v in enumerate(x):
        sq = v * v
        delta = sq - state
        if delta < 0:
            state = max(threshold * threshold, state * decay)
            if holding:
                fires[i - 1] = True
                holding = False
        else:
            if delta > hysteresis * state:
                holding = True
            state = sq
    return fires


def test_zero_crossing_matches_oracle():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(2000) * 0.5).astype(np.float32)
    for thr in (0.0, 0.2, 0.7):
        got = np.asarray(zero_crossing_triggers(jnp.asarray(x), thr))
        want = zero_crossing_oracle(x.astype(np.float64), thr)
        np.testing.assert_array_equal(got, want), thr


def test_zero_crossing_sine():
    t = np.arange(4096)
    x = np.sin(2 * np.pi * 10 * t / 4096).astype(np.float32)  # 10 cycles
    fires = np.asarray(zero_crossing_triggers(jnp.asarray(x), 0.1))
    # 9 interior rising crossings (the first is at sample 0, not countable)
    assert fires.sum() == 9
    idx, found = last_zero_crossing_trigger(jnp.asarray(x), 0.1)
    assert bool(found)
    # last rising crossing of sin at cycle 9 boundary
    assert abs(int(idx) - int(9 * 4096 / 10)) <= 1


def test_peak_hold_matches_oracle():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(1500) * 0.5).astype(np.float32)
    got, _, _ = peak_hold_triggers(jnp.asarray(x), 0.1, 0.5)
    want = _peak_hold_oracle(x.astype(np.float64), 0.1, 0.5)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_peak_hold_state_carries():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(1000) * 0.5).astype(np.float32)
    want = _peak_hold_oracle(x.astype(np.float64), 0.05, 0.3)
    f1, st, hold = peak_hold_triggers(jnp.asarray(x[:500]), 0.05, 0.3)
    f2, _, _ = peak_hold_triggers(jnp.asarray(x[500:]), 0.05, 0.3, st, hold)
    got = np.concatenate([np.asarray(f1), np.asarray(f2)])
    # the seam event (fire at index 499 needs sample 500) may differ; allow
    # one mismatch at the boundary
    mismatches = np.nonzero(got != want)[0]
    assert len(mismatches) <= 1 and all(abs(m - 500) <= 1 for m in mismatches)


# ---------------------------------------------------------------------------
# spectral trigger
# ---------------------------------------------------------------------------


def test_spectral_fundamental_pure_sine():
    n = 8192
    t = np.arange(n)
    for f_hz in (110.0, 440.0, 1763.3):
        x = np.sin(2 * np.pi * f_hz * t / FS).astype(np.float32)
        fund, cycles, record = spectral_fundamental(jnp.asarray(x), FS)
        assert abs(float(fund) - f_hz) < f_hz * 0.01, f_hz
        np.testing.assert_allclose(float(cycles), FS / float(fund), rtol=1e-6)


def test_spectral_fundamental_with_harmonics():
    """Strong 3rd harmonic must not steal the fundamental (harmonic
    rejection, OscilloscopeDSP.inl:160-180)."""
    n = 8192
    t = np.arange(n)
    f0 = 220.0
    x = (
        np.sin(2 * np.pi * f0 * t / FS)
        + 1.9 * np.sin(2 * np.pi * 3 * f0 * t / FS + 0.3)
    ).astype(np.float32)
    fund, _, _ = spectral_fundamental(jnp.asarray(x), FS)
    assert abs(float(fund) - f0) < f0 * 0.02


def test_spectral_fundamental_batched():
    n = 8192
    t = np.arange(n)
    xs = np.stack(
        [np.sin(2 * np.pi * f * t / FS) for f in (110.0, 550.0, 2000.0)]
    ).astype(np.float32)
    fund, _, _ = spectral_fundamental(jnp.asarray(xs), FS)
    np.testing.assert_allclose(np.asarray(fund), [110.0, 550.0, 2000.0], rtol=0.01)


def test_goertzel_matches_dft():
    rng = np.random.default_rng(3)
    x = rng.standard_normal(512).astype(np.float32)
    k = 37
    radians = 2 * np.pi * k / 512
    z = goertzel(jnp.asarray(x), jnp.asarray(radians, jnp.float32))
    want = np.fft.fft(x)[k]
    np.testing.assert_allclose(complex(z), want, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# resampling
# ---------------------------------------------------------------------------


def test_sinc_resample_reconstructs_bandlimited():
    """8x upsampling of a bandlimited signal must match the analytic values
    (BASELINE config 3: 8x windowed-sinc resample)."""
    n = 512
    t = np.arange(n)
    f = 0.02  # cycles/sample, far below Nyquist
    x = np.sin(2 * np.pi * f * t).astype(np.float32)
    num_out = 8 * 128
    start, step = 64.0, 1.0 / 8.0
    out = np.asarray(
        sinc_resample(jnp.asarray(x), jnp.asarray(start), jnp.asarray(step), num_out)
    )
    pos = start + np.arange(num_out) * step
    want = np.sin(2 * np.pi * f * pos)
    np.testing.assert_allclose(out, want, atol=2e-3)


def test_linear_resample_exact_at_integers():
    x = np.arange(32, dtype=np.float32)
    out = np.asarray(linear_resample(jnp.asarray(x), 4.0, 0.5, 20))
    want = 4.0 + np.arange(20) * 0.5  # linear data -> exact
    np.testing.assert_allclose(out, want, atol=1e-5)


def test_minmax_decimate():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 1024)).astype(np.float32)
    mins, maxs = minmax_decimate(jnp.asarray(x), 64)
    want_min = x.reshape(3, 64, 16).min(-1)
    want_max = x.reshape(3, 64, 16).max(-1)
    np.testing.assert_allclose(np.asarray(mins), want_min, atol=1e-7)
    np.testing.assert_allclose(np.asarray(maxs), want_max, atol=1e-7)
    assert np.all(np.asarray(mins) <= np.asarray(maxs))


# ---------------------------------------------------------------------------
# processor end-to-end
# ---------------------------------------------------------------------------


def _history(f_hz=440.0, h=16384, pairs=1, phase=0.0):
    t = np.arange(h)
    x = np.sin(2 * np.pi * f_hz * t / FS + phase).astype(np.float32)
    return np.broadcast_to(x, (pairs, 2, h)).copy()


@pytest.mark.parametrize(
    "mode",
    [
        TriggerMode.NONE,
        TriggerMode.SPECTRAL,
        TriggerMode.WINDOW,
        TriggerMode.ENVELOPE_HOLD,
        TriggerMode.ZERO_CROSSING,
    ],
)
def test_processor_modes_run(mode):
    proc = OscilloscopeProcessor(
        pairs=2,
        trigger_mode=mode,
        window_samples=2000.0,
        pixels=256,
        lookahead=8192,
        colour_enabled=True,
        autogain=True,
    )
    frame = proc.process(_history(pairs=2))
    assert frame.waveform.shape == (2, 2, 256)
    assert frame.colours.shape == (2, 2, 256, 3)
    assert np.all(np.isfinite(np.asarray(frame.waveform)))
    frame2 = proc.process(_history(pairs=2))  # state carries
    assert np.all(np.isfinite(np.asarray(frame2.waveform)))


def test_spectral_trigger_phase_locks():
    """The defining observable: with spectral triggering, histories whose
    sines differ by an arbitrary phase must produce (nearly) identical
    display windows (ref: phase-locked waveform, OscilloscopeDSP.inl:283-307)."""
    f_hz = 441.3
    windows = []
    for phase in (0.0, 1.1, 2.9):
        proc = OscilloscopeProcessor(
            pairs=1,
            trigger_mode=TriggerMode.SPECTRAL,
            channel_mode=OscChannels.LEFT,
            window_samples=1000.0,
            pixels=500,
            interpolation=SubSampleInterpolation.LANCZOS,
        )
        frame = proc.process(_history(f_hz=f_hz, phase=phase))
        windows.append(np.asarray(frame.waveform)[0, 0])
    for w in windows[1:]:
        # ignore edge pixels where sinc taps clamp
        np.testing.assert_allclose(w[16:-16], windows[0][16:-16], atol=0.02)


def test_zero_crossing_centers_window():
    """ZC mode: the center pixel must sit on a rising zero crossing."""
    proc = OscilloscopeProcessor(
        pairs=1,
        trigger_mode=TriggerMode.ZERO_CROSSING,
        channel_mode=OscChannels.LEFT,
        window_samples=1001.0,
        pixels=1001,
        trigger_threshold=0.1,
        interpolation=SubSampleInterpolation.LANCZOS,
    )
    frame = proc.process(_history(f_hz=440.0, phase=0.7))
    wave = np.asarray(frame.waveform)[0, 0]
    center = len(wave) // 2
    # the crossing origin is the first sample AFTER the sign change, so its
    # value is bounded by one sample step of the sine (2*pi*440/48000 ~ 0.058)
    assert abs(wave[center]) < 0.06  # on the crossing
    assert wave[center + 5] > wave[center - 5]  # rising


def test_autogain_normalizes_quiet_signal():
    proc = OscilloscopeProcessor(
        pairs=1, autogain=True, channel_mode=OscChannels.LEFT, window_samples=4096.0, pixels=128
    )
    frame = proc.process(_history() * 0.01)
    np.testing.assert_allclose(float(frame.gain[0]), 100.0, rtol=0.01)
    assert abs(np.asarray(frame.waveform).max() - 1.0) < 0.05


def test_sinc_resample_static_matches_gather():
    """The matmul resample (static pixel grid) must match the dynamic
    gather path to float32 precision."""
    from signalizer_tpu.kernels.oscilloscope import (
        sinc_resample_matrix,
        sinc_resample_static,
    )

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 512)).astype(np.float32)
    m = sinc_resample_matrix(512, 64.0, 0.125, 1024)
    got = np.asarray(sinc_resample_static(jnp.asarray(x), m))
    want = np.asarray(
        sinc_resample(jnp.asarray(x), jnp.full((3,), 64.0), jnp.full((3,), 0.125), 1024)
    )
    # 5e-5: the gather evaluates the kernel in f32, the host matrix in f64
    np.testing.assert_allclose(got, want, atol=5e-5)


# ---------------------------------------------------------------------------
# custom trigger frequency + RMS autogain (round-2 wiring)
# ---------------------------------------------------------------------------


def test_custom_trigger_locks_to_user_frequency():
    """With CustomTrigger on, the phase lock must follow the *user*
    frequency even when another partial dominates the spectrum
    (ref: OscilloscopeDSP.inl:69-78 short-circuits the search)."""
    from signalizer_tpu.views.oscilloscope import AutoGain

    f_user = 441.3
    f_loud = 997.0
    windows = []
    for phase in (0.0, 1.3, 2.7):
        t = np.arange(16384)
        # the user tone is 20 dB below the dominant one, and both move
        # together in phase so a correct lock shows identical windows
        x = (0.1 * np.sin(2 * np.pi * f_user * t / FS + phase)
             + 1.0 * np.sin(2 * np.pi * f_loud * t / FS + phase * f_loud / f_user)).astype(np.float32)
        hist = np.broadcast_to(x, (1, 2, 16384)).copy()
        proc = OscilloscopeProcessor(
            pairs=1,
            trigger_mode=TriggerMode.SPECTRAL,
            channel_mode=OscChannels.LEFT,
            window_samples=1000.0,
            pixels=500,
            custom_trigger=True,
            custom_trigger_frequency=f_user,
        )
        frame = proc.process(hist)
        assert float(frame.fundamental[0]) == pytest.approx(f_user)
        windows.append(np.asarray(frame.waveform)[0, 0])
    for w in windows[1:]:
        np.testing.assert_allclose(w[16:-16], windows[0][16:-16], atol=0.05)


def test_rms_and_peak_autogain_diverge():
    """RMS gain ~ sqrt(2)/A for a steady sine; peak gain ~ 1/A
    (ref: OscilloscopeDSP.inl:684-698 vs runPeakFilter :712-886)."""
    from signalizer_tpu.views.oscilloscope import AutoGain

    amp = 0.25
    hist = _history() * amp

    def gain_for(mode):
        proc = OscilloscopeProcessor(
            pairs=1, autogain=mode, channel_mode=OscChannels.LEFT,
            window_samples=2048.0, pixels=64, envelope_window_ms=20.0,
        )
        # run a few blocks so the RMS one-pole converges
        for _ in range(4):
            frame = proc.process(hist)
        return float(frame.gain[0])

    g_peak = gain_for(AutoGain.PEAK_DECAY)
    g_rms = gain_for(AutoGain.RMS)
    assert g_peak == pytest.approx(1.0 / amp, rel=0.01)
    assert g_rms == pytest.approx(np.sqrt(2.0) / amp, rel=0.02)
    assert g_rms > g_peak * 1.3


def test_rms_block_update_matches_per_sample_oracle():
    """Closed-form block one-pole == the reference's per-sample recurrence."""
    from signalizer_tpu.views.oscilloscope import AutoGain

    rng = np.random.default_rng(3)
    h = 2048
    x = rng.standard_normal(h).astype(np.float32) * 0.5
    hist = np.broadcast_to(x, (1, 2, h)).copy()
    win_ms = 5.0
    proc = OscilloscopeProcessor(
        pairs=1, autogain=AutoGain.RMS, channel_mode=OscChannels.LEFT,
        window_samples=512.0, pixels=32, envelope_window_ms=win_ms,
    )
    # two calls: first sees all h samples new, second sees 300 new ones
    proc.process(hist)
    hist2 = np.roll(hist, -300, axis=-1)
    frame = proc.process(hist2, new_samples=300)

    c = np.exp(-1.0 / (win_ms * 1e-3 * FS))
    env = 0.0
    for s in x:
        env = s * s + c * (env - s * s)
    for s in hist2[0, 0, -300:]:
        env = s * s + c * (env - s * s)
    np.testing.assert_allclose(float(frame.gain[0]), 1.0 / np.sqrt(env), rtol=1e-3)


def test_envelope_window_controls_peak_decay_rate():
    """The EnvelopeWindow knob must change how fast peak autogain recovers
    after a transient (it was a dead knob in round 1)."""
    from signalizer_tpu.views.oscilloscope import AutoGain

    loud = _history() * 1.0
    quiet = _history() * 0.01

    def gain_after(win_ms):
        proc = OscilloscopeProcessor(
            pairs=1, autogain=AutoGain.PEAK_DECAY, channel_mode=OscChannels.LEFT,
            window_samples=2048.0, pixels=64, envelope_window_ms=win_ms,
        )
        proc.process(loud, new_samples=16384)
        frame = proc.process(quiet, new_samples=4096)
        return float(frame.gain[0])

    fast = gain_after(1.0)     # short window: envelope decays fast -> big gain
    slow = gain_after(5000.0)  # long window: still remembers the loud peak
    assert fast > slow * 5.0
    # exact closed form: env holds peak^2 and decays pole^n, so
    # gain = (1/peak) * exp(n / (2 * win_s * fs)) — 1.0086 here, which a
    # deleted decay (gain exactly 1/peak) must fail
    peak = float(np.max(np.abs(loud[0, 0])))
    expected = (1.0 / peak) * np.exp(4096 / (2.0 * 5.0 * FS))
    assert slow == pytest.approx(expected, rel=1e-3)
    assert slow > (1.0 / peak) * 1.003  # the decay actually advanced


def test_separate_mode_per_row_key_colours():
    """SEPARATE mode colours left/right with primary/secondary
    (ref: OscilloscopeParameters.h primaryColour/secondaryColour)."""
    proc = OscilloscopeProcessor(
        pairs=1, channel_mode=OscChannels.SEPARATE, pixels=16,
        window_samples=256.0,
        key_colour=(1.0, 0.0, 0.0), secondary_colour=(0.0, 0.0, 1.0),
    )
    frame = proc.process(_history())
    cols = np.asarray(frame.colours)  # [1, 2, 16, 3]
    np.testing.assert_array_equal(cols[0, 0, 0], [1.0, 0.0, 0.0])
    np.testing.assert_array_equal(cols[0, 1, 0], [0.0, 0.0, 1.0])


def test_window_mode_transport_sync_scrolls():
    """WINDOW mode anchors the display to the transport position modulo
    the window (ref: OscilloscopeRendering.cpp:587-592): advancing the
    transport by half a window shifts the displayed waveform accordingly."""
    proc = OscilloscopeProcessor(
        pairs=1, channel_mode=OscChannels.LEFT, trigger_mode=TriggerMode.WINDOW,
        interpolation=SubSampleInterpolation.LINEAR, window_samples=512.0, pixels=512,
    )
    hist = _history(f_hz=187.5, h=8192)  # 256-sample period
    w0 = np.asarray(proc.process(hist, transport_position=0.0).waveform)[0, 0]
    w_half = np.asarray(proc.process(hist, transport_position=256.0).waveform)[0, 0]
    w_full = np.asarray(proc.process(hist, transport_position=512.0).waveform)[0, 0]
    # a full window of transport wraps back to the same display
    np.testing.assert_allclose(w_full, w0, atol=1e-5)
    # half a window shifts by half the pixels
    np.testing.assert_allclose(w_half[:256], w0[256:], atol=1e-4)


def test_reconfigure_resets_state_on_row_change():
    """Swapping the constant resets carried state when the row count
    changes, and keeps it otherwise (handleFlagUpdates deferred resets)."""
    from signalizer_tpu.views.oscilloscope import make_oscilloscope_constant

    proc = OscilloscopeProcessor(
        pairs=1, channel_mode=OscChannels.SEPARATE, window_samples=256.0,
        pixels=32, autogain=True,
    )
    proc.process(_history())
    env_before = np.asarray(proc.state.peak_env)
    assert env_before.shape == (1, 2) and env_before.max() > 0
    # same rows: state survives
    proc.reconfigure(make_oscilloscope_constant(
        channel_mode=OscChannels.MIDSIDE, pixels=32, autogain=True))
    assert np.asarray(proc.state.peak_env).max() > 0
    # row change: state resets
    proc.reconfigure(make_oscilloscope_constant(
        channel_mode=OscChannels.LEFT, pixels=32, autogain=True))
    env = np.asarray(proc.state.peak_env)
    assert env.shape == (1, 1) and env.max() == 0.0

def test_reconfigure_updates_pair_key_colours():
    """reconfigure() must rebuild the per-pair hue-rotated key colours from
    the new constant — multi-pair processors used to keep rendering with
    the construction-time colours after a colour knob change."""
    from signalizer_tpu.views.oscilloscope import (
        OscilloscopeProcessor,
        make_oscilloscope_constant,
    )

    c1 = make_oscilloscope_constant(
        pixels=32, key_colour=(1.0, 0.0, 0.0), secondary_colour=(0.0, 1.0, 0.0)
    )
    proc = OscilloscopeProcessor(c1, pairs=2)
    before = np.asarray(proc._pair_keys)
    c2 = make_oscilloscope_constant(
        pixels=32, key_colour=(0.0, 0.0, 1.0), secondary_colour=(1.0, 1.0, 0.0)
    )
    proc.reconfigure(c2)
    after = np.asarray(proc._pair_keys)
    assert not np.allclose(before, after)
    np.testing.assert_allclose(after[0, 0], [0.0, 0.0, 1.0], atol=1e-6)

def test_median_filter_ignores_warmup_sentinels():
    """The median filter must take the single upper-middle record of the
    PRE-insert history and skip the override while it is the -1 sentinel
    (ref: OscilloscopeDSP.inl:187-213 nth_element + index != -1 check) —
    averaging the sentinels would override a stable tone with a
    fundamental that does not exist."""
    import jax.numpy as jnp

    from signalizer_tpu.kernels.oscilloscope import BinRecord, median_record_filter

    hist = jnp.full((8,), -1.0)
    rec = BinRecord(
        index=jnp.asarray(40, jnp.int32),
        value=jnp.asarray(1.0, jnp.float32),
        offset=jnp.asarray(0.0, jnp.float32),
    )
    for _ in range(8):
        hist, filtered, used = median_record_filter(hist, rec)
        assert not bool(used)
        assert float(filtered.omega()) == 40.0

def test_sinc_resample_boundary_matches_direct_sum():
    """Boundary behavior (edge taps clamp to the frame) against a direct
    per-pixel numpy tap sum — the gather path and the matrix path shared
    their edge convention, so neither alone could catch a shared clamp
    bug (review finding)."""
    from signalizer_tpu.kernels.oscilloscope import sinc_resample

    rng = np.random.default_rng(11)
    w, a, num_out = 64, 10, 48
    x = rng.standard_normal(w).astype(np.float32)

    for start, step in ((0.0, 0.37), (-3.2, 0.5), (w - 5.5, 0.25)):
        got = np.asarray(sinc_resample(jnp.asarray(x), start, step, num_out, a))
        wants = [resample_oracle(x, display_positions(start, step, num_out, fused), "lanczos", a)
                 for fused in (False, True)]
        want = min(wants, key=lambda v: float(np.max(np.abs(got - v))))
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_envelope_hold_incremental_matches_stream_oracle():
    """ENVELOPE_HOLD consumes each sample exactly once across uneven
    ticks (ref: TriggeringProcessor, StreamPreprocessing.h:270-312):
    the displayed window start must match a single numpy pass over the
    whole stream with the production selection rule (newest fire whose
    half window is complete, 8-deep queue, centered window)."""
    from signalizer_tpu.kernels.oscilloscope import sinc_resample
    from signalizer_tpu.views.oscilloscope import (
        PEAK_QUEUE_SIZE,
        OscilloscopeProcessor,
        SubSampleInterpolation,
    )

    H, window, pixels, la = 4096, 512.0, 256, 4096
    thr, hyst = 0.1, 0.5
    proc = OscilloscopeProcessor(
        pairs=1,
        trigger_mode=TriggerMode.ENVELOPE_HOLD,
        interpolation=SubSampleInterpolation.LANCZOS,
        window_samples=window,
        pixels=pixels,
        lookahead=la,
        trigger_threshold=thr,
        trigger_hysteresis=hyst,
        autogain=False,
    )
    # ~120 Hz sine: one envelope-hold fire per ~400-sample cycle — sparse
    # enough that the 8-deep queue never truncates a mature candidate
    t = np.arange(20000)
    stream = np.sin(2 * np.pi * t / 400.0).astype(np.float32)

    buf = np.zeros(H, np.float32)
    consumed = 0
    step = (window - 1.0) / (pixels - 1)
    # non-pow2 chunk sizes: every tick's valid tail starts mid-region
    for chunk_len in (317, 523, 101, 907, 679, 1111, 450, 263, 777):
        chunk = stream[consumed : consumed + chunk_len]
        buf = np.concatenate([buf[chunk_len:], chunk])
        consumed += chunk_len
        hist = np.broadcast_to(buf, (1, 2, H)).copy()
        frame = proc.process(hist, new_samples=chunk_len)

        fires = _peak_hold_oracle(stream[:consumed].astype(np.float64), thr, hyst)
        ages = consumed - 1 - np.flatnonzero(fires)
        ages = np.sort(ages)[:PEAK_QUEUE_SIZE]  # queue keeps the newest 8
        mature = ages[(ages >= window * 0.5 - 1.0) & (ages < H)]
        if mature.size:
            start = (H - 1.0 - float(mature.min())) - (window - 1.0) * 0.5
            start = float(np.clip(start, 0.0, H - window))
            assert bool(np.asarray(frame.trigger_found)[0])
        else:
            start = H - window
        want = np.asarray(
            sinc_resample(
                jnp.asarray(hist),
                jnp.full((1, 1), start, jnp.float32),
                jnp.full((1, 1), step, jnp.float32),
                pixels,
            )
        )
        np.testing.assert_allclose(
            np.asarray(frame.waveform), want, atol=2e-4,
            err_msg=f"after {consumed} samples",
        )


def test_envelope_covers_displayed_window_only():
    """The min-max envelope must decimate the displayed [start,
    start+window) region, not the whole history (round-3 review: a
    full-history envelope misaligns with the drawn trace whenever
    window < history)."""
    h, window, pixels = 4096, 1024.0, 256
    proc = OscilloscopeProcessor(
        pairs=1,
        trigger_mode=TriggerMode.NONE,
        window_samples=window,
        pixels=pixels,
        lookahead=2048,
    )
    hist = np.zeros((1, 2, h), np.float32)
    hist[:, :, 100] = 5.0  # spike far OUTSIDE the displayed tail window
    hist[:, :, h - 512] = 3.0  # spike INSIDE the window (midway)
    frame = proc.process(hist)
    env_max = np.asarray(frame.envelope_max)[0, 0]
    env_min = np.asarray(frame.envelope_min)[0, 0]
    assert env_max.max() == 3.0, "outside-window spike leaked into the envelope"
    # the inside spike lands at pixel ~ (h-512 - (h-window)) / step
    px = int(round((window - 512.0) / ((window - 1.0) / (pixels - 1))))
    assert env_max[max(0, px - 1) : px + 2].max() == 3.0
    assert env_min.min() == 0.0


def test_envelope_oversampling_hint_matches_conservative_bound():
    """process() passes a static env_os sized to the ACTUAL per-pixel
    step (pow2-bucketed) instead of the conservative ceil(h/pixels); the
    envelope must still cover every displayed sample — its global
    min/max equal the displayed window's, for downsampling and
    upsampling geometries, with and without the hint."""
    from signalizer_tpu.views.oscilloscope import osc_step_impl

    rng = np.random.default_rng(11)
    h = 4096
    hist = rng.standard_normal((1, 2, h)).astype(np.float32)
    for window, pixels in ((2048.0, 256), (512.0, 2048)):
        proc = OscilloscopeProcessor(
            pairs=1,
            trigger_mode=TriggerMode.NONE,
            window_samples=window,
            pixels=pixels,
            lookahead=2048,
        )
        frame = proc.process(hist)  # hinted path
        ref, _ = osc_step_impl(  # conservative default (env_os=None)
            proc.constant,
            proc._state,
            jnp.asarray(hist),
            jnp.float32(window),
            jnp.float32(0.0),
            jnp.float32(h),
            None,
        )
        shown = hist[0, 0, int(h - window) :]
        for fr in (frame, ref):
            assert np.asarray(fr.envelope_max)[0, 0].max() == shown.max()
            assert np.asarray(fr.envelope_min)[0, 0].min() == shown.min()


def test_envelope_fencepost_bound_drops_no_sample():
    """The conservative envelope bound must be ceil((h-1)/(pixels-1)),
    not ceil(h/pixels): when pixels divides h and window == h the true
    fence-post step (h-1)/(pixels-1) = 16.0588 exceeds ceil(h/pixels)
    = 16, and nearest sampling at that spacing provably skips source
    samples (136, 410, 683, ... at this geometry; enumerated against the
    kernel's actual rounding) — a single-sample transient there vanished
    from the envelope (review finding)."""
    from signalizer_tpu.views.oscilloscope import osc_step_impl

    h, pixels, window = 4096, 256, 4096.0
    # spike at one of the indices the old ceil(h/pixels) bound skipped
    for spike_at in (136, 410, 683):
        hist = np.zeros((1, 2, h), np.float32)
        hist[0, :, spike_at] = 3.0
        proc = OscilloscopeProcessor(
            pairs=1,
            trigger_mode=TriggerMode.NONE,
            window_samples=window,
            pixels=pixels,
            lookahead=2048,
        )
        frame = proc.process(hist)  # hinted path
        ref, _ = osc_step_impl(  # conservative default (env_os=None)
            proc.constant,
            proc._state,
            jnp.asarray(hist),
            jnp.float32(window),
            jnp.float32(0.0),
            jnp.float32(h),
            None,
        )
        for fr in (frame, ref):
            assert np.asarray(fr.envelope_max)[0, 0].max() == 3.0, (
                f"spike at {spike_at} dropped from the min-max envelope"
            )


def test_spectral_phase_lock_with_window_beyond_lookahead():
    """The displayed window must not depend on the lookahead size once
    window + cycles exceeds it (round-3 review: the reference's
    ceil(max(N, w+c)) phase correction assumes ITS buffer anchor at
    -ceil(max(N, w+c)); ours is always -N, so the correction is
    N - (w+c) — the verbatim form misplaced the lock by up to a full
    cycle in this regime; measured divergence 1.97 vs 0.0000 after the
    fix). Bin-exact frequency isolates the formula from omega
    quantization (562.5 Hz = bin 12 of 1024 = bin 96 of 8192)."""
    f_hz = 562.5
    windows = []
    for la in (1024, 8192):  # w + c ~ 2085 straddles the two regimes
        proc = OscilloscopeProcessor(
            pairs=1,
            trigger_mode=TriggerMode.SPECTRAL,
            channel_mode=OscChannels.LEFT,
            window_samples=2000.0,
            pixels=500,
            lookahead=la,
            interpolation=SubSampleInterpolation.LANCZOS,
        )
        frame = proc.process(_history(f_hz=f_hz, phase=0.9))
        windows.append(np.asarray(frame.waveform)[0, 0])
    np.testing.assert_allclose(windows[0][16:-16], windows[1][16:-16], atol=0.01)


def test_fcolourblend_polarity_matches_reference_corpus():
    """The FColourBlend knob IS the energy-colour weight: the reference
    lerps its energy colour TOWARD the key colour by (1 - knob)
    (OscilloscopeDSP.inl:493,:503), and its shipped corpus pins the
    polarity — coloured.oscilloscope.sgn (the spectral-colouring
    showcase) carries FColBlend 1.0, init 0.8. A double inversion in
    make_processor_kwargs made the knob work backwards (review
    finding)."""
    from pathlib import Path

    from signalizer_tpu.views.content import OscilloscopeContent

    oc = OscilloscopeContent()
    oc.frequency_colouring_blend.set_normalized(1.0)
    assert oc.make_processor_kwargs()["colour_blend"] == 1.0
    oc.frequency_colouring_blend.set_normalized(0.0)
    assert oc.make_processor_kwargs()["colour_blend"] == 0.0

    corpus = Path("/root/reference/Make/Skeleton/presets")
    if corpus.exists():
        from signalizer_tpu.state.sgn_import import apply_preset, load_sgn

        oc2 = OscilloscopeContent()
        apply_preset(
            load_sgn(corpus / "coloured.oscilloscope.sgn"), oscilloscope=oc2
        )
        kw = oc2.make_processor_kwargs()
        assert kw["colour_enabled"] is True
        assert kw["colour_blend"] == 1.0, (
            "the reference's colouring showcase must come through fully "
            "frequency-coloured"
        )

    # behavioural pin: blend 0 -> pure key colour; blend 1 -> pure
    # (normalized) energy colour, independent of the key
    rng = np.random.default_rng(3)
    hist = rng.standard_normal((1, 2, 2048)).astype(np.float32)
    outs = {}
    for blend, key in ((0.0, (0.2, 0.7, 0.4)), (1.0, (0.2, 0.7, 0.4)),
                       (1.0, (0.9, 0.1, 0.1))):
        proc = OscilloscopeProcessor(
            pairs=1, trigger_mode=TriggerMode.NONE, window_samples=1024.0,
            pixels=64, lookahead=1024, colour_enabled=True,
            colour_blend=blend, key_colour=key, secondary_colour=key,
        )
        outs[(blend, key)] = np.asarray(proc.process(hist).colours)
    pure_key = outs[(0.0, (0.2, 0.7, 0.4))]
    assert np.allclose(pure_key, np.asarray((0.2, 0.7, 0.4)), atol=1e-6), (
        "blend 0 must show the static key colour"
    )
    # blend 1 ignores the key colour entirely
    assert np.allclose(outs[(1.0, (0.2, 0.7, 0.4))], outs[(1.0, (0.9, 0.1, 0.1))])


def test_host_mirrors_survive_pytree_round_trips(monkeypatch):
    """Host mirrors ride the constants as STATIC aux data (HostMirror),
    so dataclasses.replace / tree_map round-trips keep them and
    host_view never falls back to a device readback (the resonator's
    _HostPoles pattern)."""
    import dataclasses as dc

    import jax

    import signalizer_tpu.core.constant as cc
    from signalizer_tpu.views.oscilloscope import (
        make_oscilloscope_constant,
        make_pair_key_colours,
    )

    def boom(x):  # noqa: ANN001
        raise AssertionError("host_view fell back to a device readback")

    monkeypatch.setattr(cc.jax, "device_get", boom)

    osc = make_oscilloscope_constant(key_colour=(0.0, 1.0, 0.0))
    for variant in (
        osc,
        dc.replace(osc, manual_gain=osc.manual_gain * 2.0),
        jax.tree_util.tree_map(lambda x: x, osc),
    ):
        kt = np.asarray(make_pair_key_colours(variant, 2))
        assert kt.shape == (2, 2, 3)

    spec = cc.make_spectrum_constant(
        axis_points=64, window_size=256, sample_rate=48_000.0
    )
    for variant in (
        spec,
        dc.replace(spec, clip_db=spec.clip_db),
        jax.tree_util.tree_map(lambda x: x, spec),
    ):
        mf = cc.host_view(variant, "mapped_frequencies")
        assert mf.shape == (64,)
        assert isinstance(float(cc.host_view(variant, "inv_size")), float)
    # identical constants agree on the static jit key
    spec2 = cc.make_spectrum_constant(
        axis_points=64, window_size=256, sample_rate=48_000.0
    )
    assert hash(spec.host_data) == hash(spec2.host_data)
    assert spec.host_data == spec2.host_data
