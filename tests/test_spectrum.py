"""Spectrum pipeline vs the independent numpy oracle (tests/oracle.py)."""

import numpy as np
import jax.numpy as jnp
import pytest

from signalizer_tpu.core.config import (
    BinInterpolation,
    SpectrumChannels,
    ViewScaling,
)
from signalizer_tpu.core.constant import make_spectrum_constant
from signalizer_tpu.core.windows import WindowType, generate_window
from signalizer_tpu.kernels.spectrum import (
    analyze_frames,
    init_line_graph_state,
    spectrum_values,
)
from signalizer_tpu.kernels.peak_decay import peak_decay_scan

from oracle import (
    db_map_oracle,
    peak_decay_oracle,
    spectrum_values_oracle,
)

FS = 48_000.0
INTERP_NAMES = {
    BinInterpolation.NONE: "none",
    BinInterpolation.LINEAR: "linear",
    BinInterpolation.LANCZOS: "lanczos",
}
CONFIG_NAMES = {
    SpectrumChannels.LEFT: "left",
    SpectrumChannels.RIGHT: "right",
    SpectrumChannels.MERGE: "merge",
    SpectrumChannels.SIDE: "side",
    SpectrumChannels.PHASE: "phase",
    SpectrumChannels.SEPARATE: "separate",
    SpectrumChannels.MIDSIDE: "midside",
    SpectrumChannels.COMPLEX: "complex",
}


def _make(config, interp, scaling, axis_points, window_size=1024, window=WindowType.HANN):
    return make_spectrum_constant(
        axis_points=axis_points,
        window_size=window_size,
        sample_rate=FS,
        configuration=config,
        bin_interpolation=interp,
        view_scaling=scaling,
        window_type=window,
        min_freq=20.0,
    )


def _oracle_vals(constant, frames, config, interp):
    kernel, scale = generate_window(
        WindowType.HANN, constant.window_size, symmetric=True
    )
    return spectrum_values_oracle(
        frames,
        config=CONFIG_NAMES[config],
        window=kernel,
        window_scale=scale,
        mapped_frequencies=np.asarray(constant.mapped_frequencies, dtype=np.float64),
        sample_rate=FS,
        transform_size=constant.transform_size,
        interpolation=INTERP_NAMES[interp],
    )


def _rand_frames(seed=0, channels=2, window=1024):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((channels, window)).astype(np.float32) * 0.3


@pytest.mark.parametrize("config", list(CONFIG_NAMES))
@pytest.mark.parametrize(
    "interp", [BinInterpolation.NONE, BinInterpolation.LINEAR, BinInterpolation.LANCZOS]
)
@pytest.mark.parametrize(
    "scaling,axis_points",
    [
        (ViewScaling.LINEAR, 257),  # coarse pixels -> bin-max dominated
        (ViewScaling.LINEAR, 1024),  # fine pixels -> interpolation dominated
        (ViewScaling.LOGARITHMIC, 331),  # mixed: interp low end, binmax high end
    ],
)
def test_values_match_oracle(config, interp, scaling, axis_points):
    constant = _make(config, interp, scaling, axis_points)
    frames = _rand_frames()
    got = np.asarray(spectrum_values(constant, jnp.asarray(frames)))
    want = _oracle_vals(constant, frames, config, interp)
    assert got.shape == want.shape
    # float32 device pipeline vs float64 oracle
    atol = 2e-4 if config != SpectrumChannels.PHASE else 2e-3
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=atol)


def test_exact_bin_sine_reads_unity():
    """Full-scale sine on an exact FFT bin -> 1.0 linear for any window."""
    n = 1024
    for wtype in (WindowType.RECTANGULAR, WindowType.HANN, WindowType.BLACKMAN):
        constant = make_spectrum_constant(
            axis_points=513,
            window_size=n,
            sample_rate=FS,
            configuration=SpectrumChannels.LEFT,
            bin_interpolation=BinInterpolation.NONE,
            view_scaling=ViewScaling.LINEAR,
            window_type=wtype,
            window_symmetric=False,
        )
        k = 64  # bin 64 of 512 -> f = 64/512 * 24000 = 3000 Hz
        t = np.arange(n)
        x = np.sin(2 * np.pi * k * t / n).astype(np.float32)
        frames = np.stack([x, np.zeros_like(x)])
        vals = np.asarray(spectrum_values(constant, jnp.asarray(frames)))[0]
        # pixel mapping: 513 points over 0..24000 -> pixel i sits on bin i
        assert abs(vals[k] - 1.0) < 1e-3, wtype


def test_phase_mode_cancellation_limits():
    """Identical channels -> cancellation 0; inverted -> cancellation 1."""
    constant = _make(SpectrumChannels.PHASE, BinInterpolation.LINEAR, ViewScaling.LINEAR, 600)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(1024).astype(np.float32) * 0.4
    same = np.asarray(spectrum_values(constant, jnp.asarray(np.stack([x, x]))))
    np.testing.assert_allclose(same[1], 0.0, atol=1e-5)
    inv = np.asarray(spectrum_values(constant, jnp.asarray(np.stack([x, -x]))))
    np.testing.assert_allclose(inv[1], 1.0, atol=1e-5)


def test_peak_decay_matches_sequential():
    rng = np.random.default_rng(7)
    xs = rng.random((17, 4, 33)).astype(np.float32)
    s0 = rng.random((4, 33)).astype(np.float32)
    pole = 0.83
    want_seq, want_final = peak_decay_oracle(s0, xs, pole)
    got_seq, got_final = peak_decay_scan(jnp.asarray(s0), jnp.asarray(xs), pole, time_axis=0)
    np.testing.assert_allclose(np.asarray(got_seq), want_seq, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got_final), want_final, rtol=1e-5, atol=1e-6)


def test_peak_decay_single_frame_fast_path():
    s0 = jnp.asarray([1.0, 0.1])
    xs = jnp.asarray([[0.5, 0.5]])
    seq, final = peak_decay_scan(s0, xs, 0.5, time_axis=0)
    np.testing.assert_allclose(np.asarray(final), [0.5, 0.5])


def test_peak_decay_valid_mask_padding_is_identity():
    """Host-padded (valid=False) frames must not advance the decay state —
    the bucketed single-dispatch tick paths rely on this."""
    rng = np.random.default_rng(9)
    xs = rng.random((5, 4, 33)).astype(np.float32)
    s0 = rng.random((4, 33)).astype(np.float32)
    pole = 0.83
    want_seq, want_final = peak_decay_oracle(s0, xs, pole)
    padded = np.zeros((8, 4, 33), np.float32)
    padded[:5] = xs
    valid = np.zeros(8, bool)
    valid[:5] = True
    got_seq, got_final = peak_decay_scan(
        jnp.asarray(s0), jnp.asarray(padded), pole, time_axis=0, valid=jnp.asarray(valid)
    )
    np.testing.assert_allclose(np.asarray(got_final), want_final, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got_seq)[:5], want_seq, rtol=1e-5, atol=1e-6)
    # padded outputs carry the final state through unchanged
    np.testing.assert_allclose(
        np.asarray(got_seq)[5:],
        np.broadcast_to(want_final, (3,) + want_final.shape),
        rtol=1e-5,
        atol=1e-6,
    )
    # single-frame fast path honours the mask too
    one, fin = peak_decay_scan(
        jnp.asarray(s0), jnp.asarray(xs[:1]), pole, time_axis=0,
        valid=jnp.asarray([False]),
    )
    np.testing.assert_allclose(np.asarray(fin), s0, rtol=1e-6)


def test_analyze_frames_valid_mask_matches_unpadded():
    """Full pipeline with a padded+masked tail == the unpadded run (state
    and the valid results)."""
    constant = _make(SpectrumChannels.LEFT, BinInterpolation.LINEAR, ViewScaling.LOGARITHMIC, 200)
    rng = np.random.default_rng(12)
    frames = rng.standard_normal((1, 3, 2, constant.window_size)).astype(np.float32)
    state = init_line_graph_state(constant, (1,))
    want = analyze_frames(constant, state, jnp.asarray(frames))
    padded = np.zeros((1, 4, 2, constant.window_size), np.float32)
    padded[:, :3] = frames
    valid = jnp.asarray([True, True, True, False])
    got = analyze_frames(
        constant, init_line_graph_state(constant, (1,)), jnp.asarray(padded), valid=valid
    )
    np.testing.assert_allclose(
        np.asarray(got.results)[:, :3], np.asarray(want.results), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(got.state.magnitude), np.asarray(want.state.magnitude), rtol=1e-5, atol=1e-6
    )


def test_analyze_frames_valid_mask_phase_mode():
    """The PHASE branch threads the mask through both the decay scan and
    the phase-smoothing scan."""
    constant = _make(SpectrumChannels.PHASE, BinInterpolation.LINEAR, ViewScaling.LINEAR, 128)
    rng = np.random.default_rng(13)
    frames = rng.standard_normal((1, 2, 2, constant.window_size)).astype(np.float32)
    state = init_line_graph_state(constant, (1,))
    want = analyze_frames(constant, state, jnp.asarray(frames))
    padded = np.zeros((1, 4, 2, constant.window_size), np.float32)
    padded[:, :2] = frames
    valid = jnp.asarray([True, True, False, False])
    got = analyze_frames(
        constant, init_line_graph_state(constant, (1,)), jnp.asarray(padded), valid=valid
    )
    np.testing.assert_allclose(
        np.asarray(got.results)[:, :2], np.asarray(want.results), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(got.state.phase), np.asarray(want.state.phase), rtol=1e-5, atol=1e-6
    )


def test_full_pipeline_db_mapping():
    """End-to-end: analyze_frames output equals oracle values -> decay -> dB."""
    constant = _make(SpectrumChannels.LEFT, BinInterpolation.LINEAR, ViewScaling.LOGARITHMIC, 200)
    frames = _rand_frames(seed=11)[None, None]  # [B=1, T=1, C, W]
    state = init_line_graph_state(constant, (1,))
    result = analyze_frames(constant, state, jnp.asarray(frames))
    assert result.results.shape == (1, 1, constant.num_line_graphs, 1, 200)

    want_vals = _oracle_vals(constant, frames[0, 0], SpectrumChannels.LEFT, BinInterpolation.LINEAR)
    # first frame from zero state: decayed state == new values
    want_db = db_map_oracle(
        want_vals[0],
        np.asarray(constant.slope_map, dtype=np.float64),
        -96.0,
        0.0,
        float(constant.clip_db),
    )
    np.testing.assert_allclose(result.results[0, 0, 0, 0], want_db, rtol=1e-3, atol=1e-3)
    # state must carry the linear (pre-dB) values
    np.testing.assert_allclose(result.state.magnitude[0, 0, 0], want_vals[0], rtol=1e-3, atol=1e-5)


def test_db_map_clips_at_zero_magnitude():
    constant = _make(SpectrumChannels.LEFT, BinInterpolation.NONE, ViewScaling.LINEAR, 64)
    frames = np.zeros((2, 1024), dtype=np.float32)
    state = init_line_graph_state(constant)
    result = analyze_frames(constant, state, jnp.asarray(frames)[None])
    np.testing.assert_allclose(np.asarray(result.results), float(constant.clip_db))


def test_view_zoom_changes_mapping():
    """viewLeft/viewRight zoom (ref: remapFrequencies against the view
    rect, TransformConstant.h:125-180): zooming into [0.25, 0.5] of a log
    axis narrows the frequency span and the pipeline still validates."""
    full = make_spectrum_constant(
        axis_points=128, window_size=1024, sample_rate=FS,
        configuration=SpectrumChannels.LEFT,
        bin_interpolation=BinInterpolation.LINEAR,
        view_scaling=ViewScaling.LOGARITHMIC, min_freq=20.0,
    )
    zoom = make_spectrum_constant(
        axis_points=128, window_size=1024, sample_rate=FS,
        configuration=SpectrumChannels.LEFT,
        bin_interpolation=BinInterpolation.LINEAR,
        view_scaling=ViewScaling.LOGARITHMIC, min_freq=20.0,
        view_left=0.25, view_right=0.5,
    )
    f_full = np.asarray(full.mapped_frequencies)
    f_zoom = np.asarray(zoom.mapped_frequencies)
    assert f_zoom[0] > f_full[0] and f_zoom[-1] < f_full[-1]
    np.testing.assert_allclose(f_zoom[0], f_full[32], rtol=0.02)  # 0.25 in
    # zoomed pipeline still matches the oracle
    frames = _rand_frames(seed=5)
    got = np.asarray(spectrum_values(zoom, jnp.asarray(frames)))
    want = _oracle_vals(zoom, frames, SpectrumChannels.LEFT, BinInterpolation.LINEAR)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def test_api_facade_imports():
    import signalizer_tpu.api as api

    assert api.SpectrumProcessor and api.SignalizerEngine and api.Archive


def test_zero_db_range_enforces_minimum():
    """A zero dB range must not divide by zero (ref: CHANGELOG 0.4.0 —
    'Graphical issue when the Spectrum has a dB range of zero')."""
    c = make_spectrum_constant(
        axis_points=64, window_size=256, low_dbs=-10.0, high_dbs=-10.0,
        configuration=SpectrumChannels.LEFT,
        bin_interpolation=BinInterpolation.LINEAR,
        view_scaling=ViewScaling.LINEAR,
    )
    assert float(c.high_dbs) > float(c.low_dbs)
    r = analyze_frames(c, init_line_graph_state(c, (1,)),
                       jnp.ones((1, 1, 2, 256), jnp.float32) * 0.5)
    assert np.isfinite(np.asarray(r.results)).all()

def test_phase_mode_state_shape_stable():
    """PHASE mode must return a LineGraphState with the same pytree shapes
    it was given — a rows=1 slice would recompile every jitted step and
    break scan carries (regression)."""
    import jax

    constant = make_spectrum_constant(
        axis_points=64,
        window_size=256,
        sample_rate=48_000.0,
        configuration=SpectrumChannels.PHASE,
        bin_interpolation=BinInterpolation.LINEAR,
        view_scaling=ViewScaling.LINEAR,
    )
    state = init_line_graph_state(constant, (1,))
    frames = jnp.asarray(
        np.random.default_rng(0).standard_normal((1, 3, 2, 256)).astype(np.float32)
    )
    r1 = analyze_frames(constant, state, frames)
    assert jax.tree_util.tree_structure(r1.state) == jax.tree_util.tree_structure(state)
    for a, b in zip(jax.tree_util.tree_leaves(r1.state), jax.tree_util.tree_leaves(state)):
        assert a.shape == b.shape and a.dtype == b.dtype
    # and it must be a valid scan carry
    def body(st, _):
        return analyze_frames(constant, st, frames).state, None
    jax.lax.scan(body, state, None, length=2)

def test_between_bin_tone_interpolates_magnitudes():
    """A windowed tone exactly between two bins: the reference abs()'s
    every spectrum cell BEFORE its interpolation loops
    (`csf[i] = std::abs(csf[i])`, TransformDSP.inl:557-560), so the
    midway pixel interpolates the two bin MAGNITUDES into a smooth ridge
    — NOT the near-antiphase complex cells (which would cancel into a
    deep notch tens of dB lower; the <complex> filter template is a
    storage type, the data is real). Pin the ridge."""
    from signalizer_tpu.core.constant import host_view
    from signalizer_tpu.kernels.spectrum import spectrum_values
    from tests.oracle import interp_at

    fs, w = 48_000.0, 256
    constant = make_spectrum_constant(
        axis_points=512,
        window_size=w,
        sample_rate=fs,
        configuration=SpectrumChannels.LEFT,
        bin_interpolation=BinInterpolation.LINEAR,
        view_scaling=ViewScaling.LINEAR,
    )
    n = constant.transform_size
    f_tone = 32.5 * fs / n  # exactly between bins 32 and 33
    t = np.arange(w) / fs
    x = np.sin(2 * np.pi * f_tone * t).astype(np.float32)
    frames = jnp.asarray(np.stack([x, np.zeros_like(x)])[None])
    vals = np.asarray(spectrum_values(constant, frames))[0, 0]  # [P]

    freqs = np.asarray(host_view(constant, "mapped_frequencies"))
    freq_to_bin = (n // 2) / (fs / 2.0)
    pos = freqs * freq_to_bin
    mask = np.asarray(host_view(constant, "interp_mask")).astype(bool)
    px = int(np.argmin(np.abs(pos - 32.5)))  # nearest pixel to the midpoint
    assert mask[px] and abs(pos[px] - 32.5) < 0.15

    from tests.oracle import half_spectrum
    win = np.asarray(host_view(constant, "window_kernel"), np.float64)
    spec = half_spectrum(np.asarray(x, np.float64), win, n)
    mag_interp = abs(interp_at(np.abs(spec), pos[px], "linear"))
    complex_interp = abs(interp_at(spec, pos[px], "linear"))
    kernel_val = vals[px] / float(host_view(constant, "inv_size"))
    # the ridge: matches magnitude interpolation...
    assert kernel_val == pytest.approx(mag_interp, rel=1e-4)
    # ...and sits far above the would-be complex-cancellation notch
    assert kernel_val > 2.0 * complex_interp


@pytest.mark.parametrize("mode", ["banded", "matmul", "both"])
@pytest.mark.parametrize(
    "cfg,interp,scaling,window",
    [
        (SpectrumChannels.SEPARATE, BinInterpolation.LINEAR, ViewScaling.LOGARITHMIC, 4096),
        (SpectrumChannels.LEFT, BinInterpolation.LANCZOS, ViewScaling.LINEAR, 1024),
        (SpectrumChannels.COMPLEX, BinInterpolation.LINEAR, ViewScaling.LOGARITHMIC, 1024),
        (SpectrumChannels.LEFT, BinInterpolation.LINEAR, ViewScaling.LOGARITHMIC, 16384),
        (SpectrumChannels.PHASE, BinInterpolation.LINEAR, ViewScaling.LOGARITHMIC, 4096),
    ],
)
def test_remap_candidates_match_production(monkeypatch, mode, cfg, interp, scaling, window):
    """The remap candidates (remap_mode=banded|matmul|both — banded
    gather segment-max, dense-matmul tap interp) are float-equivalent to
    the default gather/scatter remap across channel modes,
    interpolations, scalings and window sizes (the matmul only reorders
    the tap sum; tolerance covers the accumulation order). Routing is a
    static Constant field since round 4 (env is snapshotted at import)."""
    kwargs = dict(
        axis_points=256,
        window_size=window,
        sample_rate=48_000.0,
        configuration=cfg,
        bin_interpolation=interp,
        view_scaling=scaling,
    )
    c_ref = make_spectrum_constant(remap_mode="gather", **kwargs)
    rng = np.random.default_rng(7)
    frames = jnp.asarray(rng.standard_normal((3, 2, window)).astype(np.float32))
    want = np.asarray(spectrum_values(c_ref, frames))

    c_alt = make_spectrum_constant(remap_mode=mode, **kwargs)
    if mode in ("matmul", "both"):
        assert c_alt.interp_dense is not None
    got = np.asarray(spectrum_values(c_alt, frames))
    scale = max(float(np.max(np.abs(want))), 1e-20)
    assert np.max(np.abs(got - want)) / scale < 1e-5


def test_band_tables_tile_segment_ids_property():
    """Property: across random geometries/zooms/scalings, the banded
    chunk tables are EXACTLY the contiguous view of segment_ids — every
    owned bin appears once under the mask at its owning pixel, nothing
    else is unmasked, and single/interp pixels have all-masked rows."""
    from signalizer_tpu.core.config import SpectrumChannels as SC
    from signalizer_tpu.core.constant import build_remap_plan, remap_frequencies

    rng = np.random.default_rng(11)
    for _ in range(25):
        p = int(rng.integers(8, 600))
        window = int(2 ** rng.integers(5, 15))
        fs = float(rng.choice([44100.0, 48000.0, 96000.0, 192000.0]))
        scaling = ViewScaling(int(rng.integers(0, 2)))
        left = float(rng.uniform(0.0, 0.6))
        right = float(left + rng.uniform(0.05, 1.0 - left))
        full_circle = bool(rng.integers(0, 2))
        interp = BinInterpolation(int(rng.integers(0, 3)))
        freqs = remap_frequencies(
            p, fs, scaling, view_left=left, view_right=right,
            configuration=SC.COMPLEX if full_circle else SC.LEFT,
        )
        plan = build_remap_plan(freqs, fs, window, interp, full_circle=full_circle)
        nv, pts = plan.n_values, len(freqs)
        # every unmasked band cell points at a bin owned by that pixel
        rows = np.broadcast_to(
            np.arange(pts)[:, None], plan.band_idx.shape
        )[plan.band_mask]
        bins = plan.band_idx[plan.band_mask]
        assert bins.size == int((plan.segment_ids < pts).sum())
        assert np.array_equal(plan.segment_ids[bins], rows)
        assert np.unique(bins).size == bins.size  # each owned bin once
        # interp/single pixels carry no band
        dead = plan.interp_mask | plan.single_mask
        assert not plan.band_mask[dead].any()
        assert (plan.band_idx >= 0).all() and (plan.band_idx < nv).all()


# --- log-domain decay+dB (round 5: headline roofline put 49% of the step
# in the linear-domain decay+dB stage; kernels/spectrum._log_decay_db) ---


def _linear_post(monkeypatch_free_constant, state, frames, valid=None):
    """Reference arm: force the linear-domain decay+dB path."""
    import signalizer_tpu.kernels.spectrum as sp

    saved = sp._LOG_DECAY_MIN_T
    sp._LOG_DECAY_MIN_T = 10**9
    try:
        return analyze_frames(monkeypatch_free_constant, state, frames, valid=valid)
    finally:
        sp._LOG_DECAY_MIN_T = saved


def test_log_decay_db_matches_linear_path():
    """T >= threshold routes decay+dB through the log-domain max-plus form;
    results and carried state must match the linear-domain path within
    float rounding (same semantics, different algebra)."""
    constant = _make(
        SpectrumChannels.SEPARATE, BinInterpolation.LINEAR, ViewScaling.LOGARITHMIC, 128
    )
    rng = np.random.default_rng(21)
    frames = rng.standard_normal((2, 16, 2, constant.window_size)).astype(np.float32)
    frames[0, 3] = 0.0  # a silent frame: zeros ride as -inf in log domain
    state = init_line_graph_state(constant, (2,))
    got = analyze_frames(constant, state, jnp.asarray(frames))
    want = _linear_post(constant, state, jnp.asarray(frames))
    np.testing.assert_allclose(
        np.asarray(got.results), np.asarray(want.results), rtol=2e-4, atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(got.state.magnitude),
        np.asarray(want.state.magnitude),
        rtol=2e-4,
        atol=1e-7,
    )


def test_log_decay_db_valid_mask_matches_linear_path():
    constant = _make(
        SpectrumChannels.LEFT, BinInterpolation.LINEAR, ViewScaling.LOGARITHMIC, 96
    )
    rng = np.random.default_rng(22)
    frames = np.zeros((1, 12, 2, constant.window_size), np.float32)
    frames[:, :9] = rng.standard_normal((1, 9, 2, constant.window_size)).astype(
        np.float32
    )
    valid = jnp.asarray([True] * 9 + [False] * 3)
    state = init_line_graph_state(constant, (1,))
    got = analyze_frames(constant, state, jnp.asarray(frames), valid=valid)
    want = _linear_post(constant, state, jnp.asarray(frames), valid=valid)
    np.testing.assert_allclose(
        np.asarray(got.results)[:, :9], np.asarray(want.results)[:, :9],
        rtol=2e-4, atol=2e-4,
    )
    np.testing.assert_allclose(
        np.asarray(got.state.magnitude),
        np.asarray(want.state.magnitude),
        rtol=2e-4,
        atol=1e-7,
    )


def test_log_decay_db_chained_calls_match_one_call():
    """Two T=8 calls (log path, with the linear state round trip at the
    call boundary) == one T=16 call == the linear-domain chain."""
    constant = _make(
        SpectrumChannels.MIDSIDE, BinInterpolation.LANCZOS, ViewScaling.LOGARITHMIC, 64
    )
    rng = np.random.default_rng(23)
    frames = rng.standard_normal((1, 16, 2, constant.window_size)).astype(np.float32)
    state = init_line_graph_state(constant, (1,))
    whole = analyze_frames(constant, state, jnp.asarray(frames))
    a = analyze_frames(constant, state, jnp.asarray(frames[:, :8]))
    b = analyze_frames(constant, a.state, jnp.asarray(frames[:, 8:]))
    np.testing.assert_allclose(
        np.asarray(b.results), np.asarray(whole.results)[:, 8:], rtol=2e-4, atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(b.state.magnitude),
        np.asarray(whole.state.magnitude),
        rtol=2e-4,
        atol=1e-7,
    )


def test_log_decay_db_silence_clips():
    """All-silent input through the log path lands exactly on clip_db."""
    constant = _make(
        SpectrumChannels.LEFT, BinInterpolation.NONE, ViewScaling.LINEAR, 64
    )
    frames = np.zeros((1, 8, 2, constant.window_size), np.float32)
    state = init_line_graph_state(constant, (1,))
    result = analyze_frames(constant, state, jnp.asarray(frames))
    np.testing.assert_allclose(np.asarray(result.results), float(constant.clip_db))
    assert np.all(np.asarray(result.state.magnitude) == 0.0)


def test_decay_domain_routes_spectrogram_to_linear(monkeypatch):
    """The spectrogram family forces decay_domain='linear' (round-5 chip
    A/B: spectrogram_columns runs 2.6 us/frame slower composed after the
    log-domain decay — see post_process). 'linear' must bypass the log
    path entirely at any T; 'auto' must still take it at T >= threshold;
    and the spectrogram step itself must ride the linear route."""
    import jax

    import signalizer_tpu.kernels.spectrum as sp
    from signalizer_tpu.kernels.colormap import normalize_ratios
    from signalizer_tpu.views.spectrogram import (
        DEFAULT_GRADIENT,
        DEFAULT_RATIOS,
        _spectrogram_step,
    )

    def boom(*a, **k):
        raise AssertionError("log path taken")

    monkeypatch.setattr(sp, "_log_decay_db", boom)

    # a geometry no other test traces, so the jit cache cannot mask the
    # monkeypatch (tracing is where the route is chosen)
    constant = _make(
        SpectrumChannels.LEFT, BinInterpolation.LINEAR, ViewScaling.LOGARITHMIC, 97
    )
    rng = np.random.default_rng(3)
    frames = jnp.asarray(
        rng.standard_normal((1, 16, 2, constant.window_size)).astype(np.float32)
    )
    state = init_line_graph_state(constant, (1,))

    # explicit linear routing never touches the log path
    r = analyze_frames(constant, state, frames, decay_domain="linear")
    assert np.isfinite(np.asarray(r.results)).all()

    # the production spectrogram step rides the linear route
    colours = jnp.asarray(np.asarray(DEFAULT_GRADIENT)[None])
    ratios = jnp.asarray(normalize_ratios(DEFAULT_RATIOS), jnp.float32)
    valid = jnp.ones((16,), bool)
    cols, _ = _spectrogram_step(constant, state, frames, colours, ratios, valid)
    assert cols.shape[-1] == 4

    # default 'auto' still takes the log path at this T
    with pytest.raises(Exception):
        jax.jit(
            lambda s, f: analyze_frames(constant, s, f, decay_domain="auto")
        ).lower(state, frames)


@pytest.mark.parametrize("window_size", [32, 100, 2048, 16384])
@pytest.mark.parametrize(
    "config",
    [
        SpectrumChannels.LEFT,
        SpectrumChannels.SEPARATE,
        SpectrumChannels.MIDSIDE,
        SpectrumChannels.COMPLEX,
    ],
)
def test_fft_spectrum_across_window_sizes(window_size, config):
    """The jnp.fft spectrum (cuFFT on the GPU) against the float64 oracle
    from the smallest transform to the longest, batched over leading axes
    (non-power-of-two windows zero-pad to the next transform size)."""
    constant = _make(
        config, BinInterpolation.LINEAR, ViewScaling.LOGARITHMIC, 128,
        window_size=window_size,
    )
    rng = np.random.default_rng(window_size)
    frames = (rng.standard_normal((2, 3, 2, window_size)) * 0.3).astype(np.float32)
    got = np.asarray(spectrum_values(constant, jnp.asarray(frames)))
    assert got.shape[:2] == (2, 3)
    for i in (0, 1):
        for j in (0, 2):
            want = _oracle_vals(constant, frames[i, j], config, BinInterpolation.LINEAR)
            np.testing.assert_allclose(got[i, j], want, rtol=2e-3, atol=2e-4)
