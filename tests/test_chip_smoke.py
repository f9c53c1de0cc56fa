"""chip_smoke.py on the CPU: its comparison helpers, its oracles, each
phase at tiny sizes (the CPU device standing in for the GPU), and its
refusal to run without a GPU."""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from oracle import display_positions, resample_oracle, zero_crossing_oracle  # noqa: E402

TINY = dict(axis_points=64, pixels=128, spectrum_window=256, spectrogram_window=512, history=4096)


@pytest.fixture
def devs():
    cpu = jax.devices("cpu")[0]
    return cs.Devices(accel=cpu, cpu=cpu)


@pytest.mark.parametrize(
    "a,b,steps",
    [
        ([0, 128, 255], [0, 128, 255], 0),
        ([0, 128, 255], [1, 127, 255], 1),
        ([0, 10, 255], [3, 10, 250], 5),
    ],
)
def test_u8_max_step(a, b, steps):
    assert cs.u8_max_step(np.uint8(a), np.uint8(b)) == steps


def test_u8_max_step_no_wraparound():
    # uint8 subtraction would wrap 0 - 255 to 1
    assert cs.u8_max_step(np.uint8([0]), np.uint8([255])) == 255


def test_rel_to_peak_and_nonfinite():
    want = np.asarray([0.0, 2.0, -4.0])
    assert cs.rel_to_peak(want + [0.0, 4e-4, 0.0], want) == pytest.approx(1e-4)
    assert cs.rel_to_peak([np.nan, 2.0, -4.0], want) == float("inf")
    with pytest.raises(cs.SmokeFailure):
        cs.rel_to_peak([1.0], want)


def test_abs_scaled_floors_scale_at_one():
    assert cs.abs_scaled([0.1, 0.2], [0.1, 0.2001]) == pytest.approx(1e-4)
    assert cs.abs_scaled([10.0, 0.0], [10.001, 0.0]) == pytest.approx(0.001 / 10.001)


def test_display_dev_clips_to_visible_range():
    # below the display floor the values differ wildly but draw the same
    assert cs.display_dev([-3.0, 0.5, 1.7], [-0.2, 0.501, 1.2]) == pytest.approx(1e-3)


def test_checks_collect_and_raise():
    lines = []
    chk = cs.Checks(out=lines.append)
    chk.bound("X.a", 1e-5, 1e-4)
    chk.raise_if_failed("X")
    chk.bound("X.b", 1e-3, 1e-4)
    chk.true("X.c", False, "detail")
    with pytest.raises(cs.SmokeFailure):
        chk.raise_if_failed("X")
    assert len(chk.failures) == 2 and any("X.b" in l for l in lines)


def test_zero_crossing_oracle_matches_kernel():
    from signalizer_tpu.kernels.oscilloscope import zero_crossing_triggers

    x = cs.make_audio(4096, 48_000.0, seed=5)[0]
    for thr in (0.0, 0.1, 0.3):
        got = np.asarray(zero_crossing_triggers(jnp.asarray(x), thr))
        np.testing.assert_array_equal(got, zero_crossing_oracle(x, thr))


def test_sinc_oracle_matches_kernel():
    from signalizer_tpu.kernels.oscilloscope import sinc_resample

    x = cs.make_audio(2048, 48_000.0, seed=6)[None]  # [1, 2, W]
    start = np.asarray([[-5.0]], np.float32)
    step = np.asarray([[0.7]], np.float32)
    got = np.asarray(sinc_resample(jnp.asarray(x), start, step, 300))
    devs = [cs.rel_to_peak(got, resample_oracle(x, np.clip(display_positions(start, step, 300, fused), -11.0, 2057.0)))
            for fused in (False, True)]
    assert min(devs) < cs.OSC_REL


def _osc_frame(pairs=2, h=2048, window=300.0, pixels=128, threshold=0.1, seed=8):
    from signalizer_tpu.core.config import OscChannels
    from signalizer_tpu.views.oscilloscope import (
        OscilloscopeProcessor,
        SubSampleInterpolation,
        TriggerMode,
    )

    proc = OscilloscopeProcessor(
        pairs=pairs, channel_mode=OscChannels.SEPARATE, trigger_mode=TriggerMode.ZERO_CROSSING,
        interpolation=SubSampleInterpolation.LANCZOS, window_samples=window, pixels=pixels,
        lookahead=1024, trigger_threshold=threshold, autogain=True,
    )
    hist = np.stack([cs.make_audio(h, 48_000.0, seed=seed + p) for p in range(pairs)])
    frame = {k: np.asarray(v) for k, v in proc.process(hist, new_samples=h)._asdict().items()}
    return proc, hist, frame, proc._prep_step(h, 0.0, h)[4]


@pytest.mark.parametrize("window", [300.0, 1500.0])
def test_osc_frame_matches_oracle_at_one_evaluation(window):
    """The processor's frame fits the trigger, resample and envelope
    oracles at one float32 evaluation of its positions, far inside the
    bound; the other evaluation is reported as the worse fit."""
    proc, hist, frame, env_os = _osc_frame(window=window)
    fused, wave_dev, env_dev = cs.osc_frame_vs_oracle(proc.constant, hist, frame, window, env_os)
    assert wave_dev < 1e-5 and env_dev < 1e-6
    assert isinstance(fused, bool)


def test_osc_frame_oracle_catches_a_shifted_window():
    """A frame drawn one pixel late fails both evaluations."""
    proc, hist, frame, env_os = _osc_frame()
    for k in ("waveform", "envelope_min", "envelope_max"):
        frame[k] = np.roll(frame[k], 1, axis=-1)
    _, wave_dev, env_dev = cs.osc_frame_vs_oracle(proc.constant, hist, frame, 300.0, env_os)
    assert wave_dev > cs.OSC_REL and env_dev > cs.OSC_REL


def test_zero_crossing_window_start_centres_newest_complete_fire():
    x = -np.ones(1000)
    x[[100, 400, 900]] = 1.0  # rising crossings at 100, 400 and 900
    # the fire at 900 has no complete half window of 200 after it
    assert cs.zero_crossing_window_start(x, 0.5, 400.0, 1000) == np.float32(400 - 199.5)
    assert cs.zero_crossing_window_start(-np.ones(1000), 0.5, 400.0, 1000) == np.float32(600.0)


def test_resonator_oracle_matches_kernel():
    from signalizer_tpu.kernels.resonator import (
        init_resonator_state,
        make_block_plan,
        make_resonator_constant,
        resonate_block,
        resonator_readout,
    )

    rc = make_resonator_constant(np.linspace(100.0, 8000.0, 16), 48_000.0, 512)
    x = cs.make_audio(1024, 48_000.0, seed=7)[0]
    st = resonate_block(rc, init_resonator_state(rc), jnp.asarray(x), make_block_plan(rc, 1024))
    got = np.asarray(resonator_readout(rc, st))
    want = cs.resonator_oracle(rc.host_poles.array(), np.asarray(rc.combine), np.asarray(rc.gain), x)
    assert cs.abs_scaled(got, want) < cs.RES_ATOL


def test_phase_a_session_tiny(devs, tmp_path):
    from signalizer_tpu.utils.exception_log import get_exception_log_path, set_exception_log_path

    before = get_exception_log_path()
    log = tmp_path / "exceptions.log"
    log.touch()
    set_exception_log_path(log)
    try:
        chk = cs.Checks(out=lambda s: None)
        info = cs.phase_session(devs, chk, seconds=0.2, out=lambda s: None, **TINY)
        chk.raise_if_failed("A")
        assert cs.exception_log_empty(log)
    finally:
        set_exception_log_path(before)
    assert info["ticks"] >= 10 and info["fused"] == info["ticks"]
    assert "A.spectrum_vs_oracle" in chk.worst and "A.resample_vs_oracle" in chk.worst
    assert chk.worst["A.osc_waveform_vs_oracle"] < 1e-5 and chk.worst["A.osc_envelope_vs_oracle"] < 1e-6


def test_phase_b_resonator_session_tiny(devs):
    chk = cs.Checks(out=lambda s: None)
    info = cs.phase_session(devs, chk, preset="constantQ.spectrum", seconds=0.2,
                            out=lambda s: None, **TINY)
    chk.raise_if_failed("B")
    assert info["fused"] == 0  # RSNT consumes the continuous stream
    assert "B.resonator_vs_oracle" in chk.worst


def test_phase_c_oscilloscope_tiny(devs):
    chk = cs.Checks(out=lambda s: None)
    cs.phase_osc(devs, chk, pairs=2, pixels=256, history=2048, window=256.0,
                 lookahead=1024, steps=2, out=lambda s: None)
    chk.raise_if_failed("C")
    assert chk.worst["C.osc_waveform_vs_oracle"] < 1e-5
    assert chk.worst["C.osc_envelope_vs_oracle"] < 1e-6


def test_phase_d_spectrogram_tiny(devs):
    chk = cs.Checks(out=lambda s: None)
    info = cs.phase_spectrogram(devs, chk, window=1024, axis_points=64, seconds=0.2,
                                out=lambda s: None)
    chk.raise_if_failed("D")
    assert info["columns"] > 0


def test_phase_e_four_devices_tiny():
    assert len(jax.devices()) >= 4  # conftest's virtual CPU devices
    chk = cs.Checks(out=lambda s: None)
    cs.phase_four_cards(chk, n_devices=4, pairs=8, window=256, history=2048, pixels=128,
                        ticks=3, out=lambda s: None)
    chk.raise_if_failed("E")
    assert {"E.fused", "E.resonator", "E.mix"} <= set(chk.worst)


def test_main_without_gpu_exits_nonzero(capsys):
    rc = cs.main([])
    out = capsys.readouterr().out
    assert rc != 0
    assert '"ok": true' not in out and out.strip() == ""


def test_script_alone_fails(tmp_path):
    """Copied out of the checkout, the script has nothing to run."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.gpu
def test_smoke_phase_c_on_gpu(gpu_device):
    cpu = jax.devices("cpu")[0]
    chk = cs.Checks()
    cs.phase_osc(cs.Devices(gpu_device, cpu), chk, pairs=2, pixels=512, history=4096,
                 window=512.0, lookahead=2048, steps=2)
    chk.raise_if_failed("C")
