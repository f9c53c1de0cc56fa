"""Resonator bank: unity calibration, selectivity, block equivalence."""

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from signalizer_tpu.core.windows import WindowType
from signalizer_tpu.kernels.resonator import (
    init_resonator_state,
    make_block_plan,
    make_resonator_constant,
    resonate_block,
    resonate_chunks,
    resonator_readout,
)

FS = 48_000.0


def _run(constant, x, chunks=1):
    state = init_resonator_state(constant)
    n = len(x) // chunks
    for i in range(chunks):
        state = resonate_block(constant, state, jnp.asarray(x[i * n : (i + 1) * n]))
    return state


def test_sine_reads_unity_at_its_pixel():
    freqs = np.linspace(100.0, 10_000.0, 64)
    constant = make_resonator_constant(freqs, FS, window_size=2048)
    f = freqs[20]
    t = np.arange(8192)
    x = np.sin(2 * np.pi * f * t / FS).astype(np.float32)
    state = _run(constant, x)
    mags = np.asarray(resonator_readout(constant, state))
    assert abs(mags[20] - 1.0) < 0.02
    # off pixels read much lower (window selectivity)
    assert mags[40] < 0.05 and mags[5] < 0.05


def test_per_sample_recurrence_equivalence():
    """Block closed form == naive per-sample recurrence."""
    freqs = np.asarray([440.0, 1000.0])
    constant = make_resonator_constant(freqs, FS, window_size=256)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(300).astype(np.float32)

    state_pairs = np.asarray(_run(constant, x))
    state = state_pairs[..., 0] + 1j * state_pairs[..., 1]
    pole_pairs = np.asarray(constant.poles)
    poles = pole_pairs[..., 0] + 1j * pole_pairs[..., 1]
    want = np.zeros_like(state)
    for s in x.astype(np.float64):
        want = want * poles + s
    np.testing.assert_allclose(state, want, rtol=2e-3, atol=2e-3)


def test_chunked_equals_single_block():
    freqs = np.linspace(200, 5000, 16)
    constant = make_resonator_constant(freqs, FS, window_size=512)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(1024).astype(np.float32)
    s1 = np.asarray(_run(constant, x, chunks=1))
    s4 = np.asarray(_run(constant, x, chunks=4))
    np.testing.assert_allclose(s1, s4, rtol=2e-3, atol=1e-3)


def test_block_plan_matches_in_graph_ramp():
    """Precomputed ramp plan == the in-graph power computation."""
    freqs = np.linspace(200, 5000, 16)
    c = make_resonator_constant(freqs, FS, window_size=512)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal(128).astype(np.float32))
    s0 = init_resonator_state(c)
    plain = np.asarray(resonate_block(c, s0, x))
    planned = np.asarray(resonate_block(c, s0, x, make_block_plan(c, 128)))
    np.testing.assert_allclose(plain, planned, rtol=1e-4, atol=1e-5)


def test_resonate_chunks_scan_matches_sequential():
    """One scanned dispatch over padded+masked chunks == per-chunk calls."""
    freqs = np.linspace(200, 5000, 16)
    c = make_resonator_constant(freqs, FS, window_size=512)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 4, 128)).astype(np.float32)  # [..., T=4, W]
    seq = init_resonator_state(c, (2, 3))
    for t in range(4):
        seq = resonate_block(c, seq, jnp.asarray(x[:, :, t]))
    padded = np.zeros((2, 3, 8, 128), np.float32)
    padded[:, :, :4] = x
    valid = np.zeros(8, bool)
    valid[:4] = True
    got = resonate_chunks(
        c,
        init_resonator_state(c, (2, 3)),
        jnp.asarray(padded),
        valid=jnp.asarray(valid),
        plan=make_block_plan(c, 128),
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(seq), rtol=2e-3, atol=1e-3)


def test_resonate_chunks_emit_readouts():
    freqs = np.linspace(200.0, 5000.0, 8)
    c = make_resonator_constant(freqs, FS, window_size=256)
    rng = np.random.default_rng(5)
    chunks = jnp.asarray(rng.standard_normal((1, 4, 64)).astype(np.float32))
    final, ys = resonate_chunks(
        c, init_resonator_state(c, (1,)), chunks, emit_readouts=True
    )
    assert ys.shape == (4, 1, 8)  # [T, batch, P]
    np.testing.assert_allclose(
        np.asarray(ys[-1]), np.asarray(resonator_readout(c, final)), rtol=1e-5, atol=1e-6
    )


def test_processor_process_chunks_matches_sequential():
    """ResonatorSpectrumProcessor: the one-dispatch tick path drives the
    bank exactly like the per-chunk loop (resonator state parity), and
    padding+mask is invariant.

    Display results deliberately differ from the per-chunk loop: the tick
    path applies the peak-decay filter ONCE per tick — the reference's
    cadence (one mapAndTransformDFTFilters per rendered frame,
    TransformDSP.inl:1297) — where the round-2 loop applied it once per
    1024-sample chunk (decay rate then depended on the backlog size).
    """
    from signalizer_tpu.core.config import (
        BinInterpolation,
        SpectrumChannels,
        ViewScaling,
    )
    from signalizer_tpu.core.constant import make_spectrum_constant
    from signalizer_tpu.views.spectrum import ResonatorSpectrumProcessor

    kwargs = dict(
        axis_points=64,
        window_size=1024,
        sample_rate=FS,
        configuration=SpectrumChannels.MIDSIDE,
        bin_interpolation=BinInterpolation.LINEAR,
        view_scaling=ViewScaling.LINEAR,
    )
    rng = np.random.default_rng(6)
    audio = rng.standard_normal((1, 2, 3, 256)).astype(np.float32)

    a = ResonatorSpectrumProcessor(make_spectrum_constant(**kwargs))
    for t in range(3):
        a.process(audio[:, :, t])

    b = ResonatorSpectrumProcessor(make_spectrum_constant(**kwargs))
    padded = np.zeros((1, 2, 4, 256), np.float32)
    padded[:, :, :3] = audio
    valid = np.asarray([True, True, True, False])
    out_b = b.process_chunks(padded, valid)

    c = ResonatorSpectrumProcessor(make_spectrum_constant(**kwargs))
    out_c = c.process_chunks(audio)  # exact T, no padding

    # the bank state is chunk-loop exact, and padding is invariant
    np.testing.assert_allclose(
        np.asarray(a._res_state), np.asarray(b._res_state), rtol=2e-3, atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(out_b), np.asarray(out_c), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(b._res_state), np.asarray(c._res_state), rtol=1e-5, atol=1e-6
    )


def test_free_q_constant_cycles():
    """free_q: low pixels integrate longer windows than high pixels."""
    freqs = np.asarray([100.0, 1000.0, 10_000.0])
    c = make_resonator_constant(freqs, FS, window_size=65536, free_q=True, min_cycles=8)
    pole_pairs = np.asarray(c.poles)
    radii = np.abs(pole_pairs[..., 0] + 1j * pole_pairs[..., 1])[:, c.vectors // 2]
    n_eff = 2.0 / (1.0 - radii)
    # ~8 cycles each
    np.testing.assert_allclose(n_eff * freqs / FS, 8.0, rtol=0.05)


def test_batched_resonate():
    freqs = np.linspace(100, 4000, 8)
    constant = make_resonator_constant(freqs, FS, window_size=512)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 512)).astype(np.float32)
    state = init_resonator_state(constant, (3,))
    state = resonate_block(constant, state, jnp.asarray(x))
    assert state.shape == (3, 8, constant.vectors, 2)  # (re, im) pairs
    # each batch row independent
    s0 = resonate_block(constant, init_resonator_state(constant), jnp.asarray(x[0]))
    np.testing.assert_allclose(np.asarray(state[0]), np.asarray(s0), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("wt", [WindowType.RECTANGULAR, WindowType.HANN, WindowType.BLACKMAN])
def test_windows_calibrated(wt):
    freqs = np.linspace(500, 8000, 32)
    constant = make_resonator_constant(freqs, FS, window_size=1024, window_type=wt)
    f = freqs[16]
    t = np.arange(8192)
    x = np.sin(2 * np.pi * f * t / FS).astype(np.float32)
    mags = np.asarray(resonator_readout(constant, _run(constant, x)))
    assert abs(mags[16] - 1.0) < 0.03, wt


def test_resonator_spectrum_processor_end_to_end():
    """RSNT view path: a sine reads 1.0 normalized dB at its own pixel."""
    from signalizer_tpu.core.config import (
        SpectrumChannels,
        TransformAlgorithm,
        ViewScaling,
    )
    from signalizer_tpu.core.constant import make_spectrum_constant
    from signalizer_tpu.views.spectrum import ResonatorSpectrumProcessor

    c = make_spectrum_constant(
        axis_points=64,
        window_size=1024,
        configuration=SpectrumChannels.LEFT,
        view_scaling=ViewScaling.LINEAR,
        algo=TransformAlgorithm.RESONATOR,
    )
    p = ResonatorSpectrumProcessor(c, pairs=1)
    t = np.arange(4096)
    f = float(np.asarray(c.mapped_frequencies)[16])
    x = np.sin(2 * np.pi * f * t / FS).astype(np.float32)
    blk = np.stack([x, np.zeros_like(x)])[None]
    for i in range(4):
        r = p.process(blk[:, :, i * 1024 : (i + 1) * 1024])
    row = np.asarray(r)[0, 0, 0, 0]
    assert int(np.argmax(row)) == 16
    assert abs(float(row[16]) - 1.0) < 0.01


def test_rsnt_phase_mode_cancellation_semantics():
    """RSNT + Phase must feed post_process (mid, cancellation) built from
    the COMPLEX per-channel states (ref: mapResonatingSystem Phase
    branch, TransformDSP.inl:1111-1127) — round-3 review found raw
    per-channel magnitudes going in instead. Observable: inverted stereo
    (R = -L) reads near-full cancellation at the tone's pixel, mono
    (R = L) reads ~none; the mid row is identical in both."""
    from signalizer_tpu.core.config import (
        SpectrumChannels,
        TransformAlgorithm,
        ViewScaling,
    )
    from signalizer_tpu.core.constant import make_spectrum_constant
    from signalizer_tpu.views.spectrum import ResonatorSpectrumProcessor

    c = make_spectrum_constant(
        axis_points=64,
        window_size=1024,
        configuration=SpectrumChannels.PHASE,
        view_scaling=ViewScaling.LINEAR,
        algo=TransformAlgorithm.RESONATOR,
    )
    t = np.arange(4096)
    f = float(np.asarray(c.mapped_frequencies)[16])
    x = np.sin(2 * np.pi * f * t / FS).astype(np.float32)

    def run(r_sign):
        p = ResonatorSpectrumProcessor(c, pairs=1)
        blk = np.stack([x, r_sign * x])[None]
        for i in range(4):
            res = p.process(blk[:, :, i * 1024 : (i + 1) * 1024])
        return np.asarray(res)[0, 0, 0]  # [rows=2, P]

    mono = run(+1.0)
    inverted = run(-1.0)
    # mid magnitude row identical regardless of polarity
    np.testing.assert_allclose(mono[0], inverted[0], atol=1e-4)
    # phase (cancellation) row: inverted reads near the mid level at the
    # tone's pixel (cancel ~1 -> phase target ~mag), mono reads at the
    # clip floor (cancel ~0)
    assert inverted[1][16] > mono[1][16] + 0.5


def test_block_plan_survives_pytree_roundtrip():
    """The host pole mirror is static aux data: tree_map / jit
    reconstruction / checkpoint restore must not lose it (a stapled-on
    attribute vanished on flatten, turning plan builds into float32
    readbacks of the poles)."""
    rc = make_resonator_constant(np.linspace(50, 20000, 32), FS, 512)
    rc2 = jax.tree_util.tree_map(lambda x: x, rc)
    assert rc2.host_poles is not None
    p1 = make_block_plan(rc, 64)
    p2 = make_block_plan(rc2, 64)
    np.testing.assert_array_equal(np.asarray(p1.ramp), np.asarray(p2.ramp))
    np.testing.assert_array_equal(np.asarray(p1.decay), np.asarray(p2.decay))


class _AcceleratorLeaf:
    """A pole leaf that reports a non-CPU device, as a constant placed on
    the GPU does; ``np.asarray`` reads it back."""

    def __init__(self, data):
        self._data = np.asarray(data)
        self.shape = self._data.shape
        self.dtype = self._data.dtype

    def devices(self):
        import types

        return {types.SimpleNamespace(platform="gpu")}

    def __array__(self, dtype=None, copy=None):
        return self._data if dtype is None else self._data.astype(dtype)


@pytest.mark.parametrize("block", [64, 256])
def test_block_plan_reads_back_poles_on_accelerator(block):
    """Without the host mirror, the plan reads the pole leaf back from
    whatever device holds it and agrees with the mirror's plan to
    float32 rounding of the poles."""
    import dataclasses

    rc = make_resonator_constant(np.linspace(50, 20000, 32), FS, 512)
    bare = dataclasses.replace(
        rc, host_poles=None, poles=_AcceleratorLeaf(np.asarray(rc.poles))
    )
    want = make_block_plan(rc, block)
    got = make_block_plan(bare, block)
    assert got.block == block
    np.testing.assert_allclose(
        np.asarray(got.ramp), np.asarray(want.ramp), atol=5e-5
    )
    np.testing.assert_allclose(
        np.asarray(got.decay), np.asarray(want.decay), atol=5e-5
    )
