"""DevicePresentationHistory — hop-only device ring behind the session tick.

Parity contract: `window(n)` must equal `AudioStreamOutput.get_history(n)`
bit-exactly across ragged pushes, pre-attach prefill, overruns and
re-primes; a device-history session must produce bit-identical SessionFrames
to a host-path session (the reference reads its history ring in place per
render frame, SpectrumRendering.cpp:620-635 — this is the rebuild's
equivalent, with only new samples crossing the host->device link)."""

import numpy as np
import pytest

from signalizer_tpu.engine import SignalizerEngine
from signalizer_tpu.session import AnalysisSession
from signalizer_tpu.stream.audio_stream import AudioStream, AudioStreamInfo, Playhead
from signalizer_tpu.stream.device_history import DevicePresentationHistory

FS = 48_000.0


def _stream(channels=2, cap=4096):
    info = AudioStreamInfo(
        channels=channels, sample_rate=FS, audio_history_capacity=cap
    )
    return AudioStream.create(False, info)


def _blocks(rng, channels, sizes):
    return [rng.standard_normal((channels, n)).astype(np.float32) for n in sizes]


def test_window_matches_host_ring_ragged():
    rng = np.random.default_rng(0)
    inp, out = _stream(cap=2048)
    dh = DevicePresentationHistory(out)
    sizes = [1, 7, 128, 300, 1, 64, 512, 2048, 3, 5000, 17, 999]
    for i, b in enumerate(_blocks(rng, 2, sizes)):
        inp.process_incoming_audio(b, Playhead())
        if i % 3 == 2:  # sync at an uneven cadence (multiple blocks/tick)
            dh.sync()
            for n in (1, 5, 128, 1000, 2048):
                np.testing.assert_array_equal(
                    np.asarray(dh.window(n)), out.get_history(n),
                    err_msg=f"push #{i} window {n}",
                )
    # zero-pending sync is a no-op
    r0 = dh.sync()
    np.testing.assert_array_equal(np.asarray(dh.sync()), np.asarray(r0))
    dh.close()


def test_prefill_covers_pre_attach_audio():
    rng = np.random.default_rng(1)
    inp, out = _stream(cap=1024)
    for b in _blocks(rng, 2, [400, 700]):  # audio before the ring attaches
        inp.process_incoming_audio(b, Playhead())
    dh = DevicePresentationHistory(out)
    np.testing.assert_array_equal(np.asarray(dh.window(1024)), out.get_history(1024))
    # and post-attach audio continues seamlessly on top of the prefill
    inp.process_incoming_audio(_blocks(rng, 2, [333])[0], Playhead())
    dh.sync()
    np.testing.assert_array_equal(np.asarray(dh.window(1024)), out.get_history(1024))
    dh.close()


def test_overrun_reprimes_on_grid():
    """More pending than the whole ring between syncs -> full re-prime,
    still bit-exact with the host ring."""
    rng = np.random.default_rng(2)
    inp, out = _stream(cap=512)
    dh = DevicePresentationHistory(out)
    for b in _blocks(rng, 2, [100, 512, 512, 300]):  # 1424 samples, H=512
        inp.process_incoming_audio(b, Playhead())
    dh.sync()
    np.testing.assert_array_equal(np.asarray(dh.window(512)), out.get_history(512))
    # pending stays bounded near H even without syncs (freeze semantics)
    for b in _blocks(rng, 2, [512] * 8):
        inp.process_incoming_audio(b, Playhead())
    assert dh._pending_n <= 2 * 512
    dh.sync()
    np.testing.assert_array_equal(np.asarray(dh.window(512)), out.get_history(512))
    dh.close()


def test_mono_stream_windows():
    rng = np.random.default_rng(3)
    inp, out = _stream(channels=1, cap=1024)
    dh = DevicePresentationHistory(out)
    inp.process_incoming_audio(_blocks(rng, 1, [700])[0], Playhead())
    dh.sync()
    w = np.asarray(dh.window(256, pad_to=2))
    assert w.shape == (2, 256)
    np.testing.assert_array_equal(w[:1], out.get_history(256))
    np.testing.assert_array_equal(w[1], np.zeros(256, np.float32))
    dh.close()


def _sine_block(n=4096, f=440.0, phase=0.0):
    t = np.arange(n) / FS
    x = 0.5 * np.sin(2 * np.pi * f * t + phase).astype(np.float32)
    return np.stack([x, 0.8 * x])


def _tree_equal(a, b, path=""):
    if a is None or b is None:
        assert a is None and b is None, path
        return
    if hasattr(a, "_fields"):  # NamedTuple frames
        for f in a._fields:
            _tree_equal(getattr(a, f), getattr(b, f), f"{path}.{f}")
        return
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _tree_equal(a[k], b[k], f"{path}.{k}")
        return
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, f"{path}[{i}]")
        return
    if isinstance(a, (str, bytes, bool, int)):
        assert a == b, path
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


@pytest.mark.parametrize("views", [("spectrum", "oscilloscope", "vectorscope")])
def test_session_device_history_bit_exact_vs_host(views):
    """The device-history session is indistinguishable from the host-path
    session: same audio in, bit-identical SessionFrames out."""
    frames = {}
    for device in (False, True):
        eng = SignalizerEngine("dh-parity", load_default_preset=False)
        s = AnalysisSession(
            eng, views=views, axis_points=128, pixels=64, device_history=device
        )
        assert (s._device_history is not None) == device
        out = []
        for i in range(4):
            s.feed(
                _sine_block(2048, phase=0.7 * i),
                Playhead(steady_clock=i * 2048, bpm=120.0, is_playing=True),
            )
            out.append(s.tick())
        frames[device] = out
        s.close()
    for f_host, f_dev in zip(frames[False], frames[True]):
        _tree_equal(f_host.spectrum, f_dev.spectrum, "spectrum")
        _tree_equal(f_host.oscilloscope, f_dev.oscilloscope, "oscilloscope")
        _tree_equal(f_host.vectorscope, f_dev.vectorscope, "vectorscope")


def test_session_auto_enables_and_closes():
    eng = SignalizerEngine("dh-auto", load_default_preset=False)
    s = AnalysisSession(eng, views=("vectorscope",), axis_points=64, pixels=32)
    assert s._device_history is not None
    listeners = eng.presentation_output._listeners
    assert s._device_history in listeners
    s.close()
    assert s._device_history is None
    # spectrogram-only sessions skip the ring (hop ingest lives in the view)
    eng2 = SignalizerEngine("dh-none", load_default_preset=False)
    s2 = AnalysisSession(eng2, views=("spectrogram",), axis_points=64)
    assert s2._device_history is None
    s2.close()


def test_failed_dispatch_recovers_bit_exact(monkeypatch):
    """If the ingest dispatch dies mid-sync (a device fault), no samples are
    lost: the ring re-arms from the host ring and the next sync matches."""
    import signalizer_tpu.stream.device_history as dhm

    rng = np.random.default_rng(4)
    inp, out = _stream(cap=1024)
    dh = DevicePresentationHistory(out)
    inp.process_incoming_audio(_blocks(rng, 2, [500])[0], Playhead())
    dh.sync()

    real = dhm._ingest
    calls = {"n": 0}

    def flaky(*a, **k):
        calls["n"] += 1
        raise RuntimeError("transport down")

    inp.process_incoming_audio(_blocks(rng, 2, [321])[0], Playhead())
    monkeypatch.setattr(dhm, "_ingest", flaky)
    with pytest.raises(RuntimeError):
        dh.sync()
    assert calls["n"] == 1
    monkeypatch.setattr(dhm, "_ingest", real)
    # more audio arrives while broken; recovery must include BOTH the
    # failed upload's samples and the new ones
    inp.process_incoming_audio(_blocks(rng, 2, [77])[0], Playhead())
    dh.sync()
    np.testing.assert_array_equal(np.asarray(dh.window(1024)), out.get_history(1024))
    dh.close()


class _StampedCtx:
    """Minimal stamped ListenerContext stand-in for race simulations."""

    def __init__(self, end, gen):
        self.block_end_clock = end
        self.ring_generation = gen


def test_resize_discards_stale_pending():
    """Pending blocks delivered BEFORE a capacity/channel change must not
    leak into the re-primed ring (review finding: the host ring rebuilds to
    zeros on resize, so pre-change pending is ghost audio the host path
    would never render)."""
    rng = np.random.default_rng(5)
    inp, out = _stream(cap=2048)
    dh = DevicePresentationHistory(out)
    inp.process_incoming_audio(_blocks(rng, 2, [600])[0], Playhead())
    # deliveries are buffered in _pending, NOT synced — now the stream
    # reconfigures (host ring rebuilds from silence)
    assert dh._pending_n == 600
    out.modify_consumer_info(lambda info: setattr(info, "audio_history_capacity", 1024))
    dh.sync()
    np.testing.assert_array_equal(
        np.asarray(dh.window(1024)), out.get_history(1024)
    )
    assert not np.asarray(dh.window(1024)).any()  # silence, no ghosts
    # post-change audio chains seamlessly on the new clock domain
    inp.process_incoming_audio(_blocks(rng, 2, [300])[0], Playhead())
    dh.sync()
    np.testing.assert_array_equal(
        np.asarray(dh.window(1024)), out.get_history(1024)
    )
    dh.close()


def test_stale_redelivery_is_dropped():
    """A block whose samples are already inside a snapshot (the threaded
    stream's written-but-not-yet-delivered race, replayed deterministically
    via its clock stamp) must be dropped by the stamp filter, not shifted
    in twice."""
    rng = np.random.default_rng(6)
    inp, out = _stream(cap=1024)
    stale = _blocks(rng, 2, [200])[0]
    inp.process_incoming_audio(stale, Playhead())
    dh = DevicePresentationHistory(out)
    dh.sync()  # primes at clock 200
    assert dh._clock == 200
    # replay the last block as an in-flight re-delivery (end clock <= cut)
    dh.on_stream_audio(_StampedCtx(200, out.ring_generation), stale)
    dh.sync()
    np.testing.assert_array_equal(np.asarray(dh.window(1024)), out.get_history(1024))
    assert dh._clock == 200  # nothing ingested
    dh.close()


def test_missed_delivery_gap_reprimes():
    """A delivery the mirror never saw (dropped packet) breaks the stamp
    chain; sync must detect the gap and re-prime bit-exact instead of
    silently diverging."""
    rng = np.random.default_rng(7)
    inp, out = _stream(cap=1024)
    dh = DevicePresentationHistory(out)
    inp.process_incoming_audio(_blocks(rng, 2, [100])[0], Playhead())
    dh.sync()
    out.remove_listener(dh)  # simulate a dropped delivery
    inp.process_incoming_audio(_blocks(rng, 2, [50])[0], Playhead())
    out.add_listener(dh)
    inp.process_incoming_audio(_blocks(rng, 2, [75])[0], Playhead())
    dh.sync()
    np.testing.assert_array_equal(np.asarray(dh.window(1024)), out.get_history(1024))
    assert dh._clock == 225
    dh.close()


def test_generation_flip_back_reprimes():
    """Two quick reconfigures back to the SAME shape leave the target
    geometry unchanged but restart the host clock (new ring generation);
    pending from the old generation must trigger a re-prime, not be
    misinterpreted on the new clock."""
    rng = np.random.default_rng(8)
    inp, out = _stream(cap=1024)
    dh = DevicePresentationHistory(out)
    inp.process_incoming_audio(_blocks(rng, 2, [128])[0], Playhead())
    dh.sync()
    inp.process_incoming_audio(_blocks(rng, 2, [64])[0], Playhead())  # old gen
    out.modify_consumer_info(lambda info: setattr(info, "audio_history_capacity", 512))
    out.modify_consumer_info(lambda info: setattr(info, "audio_history_capacity", 1024))
    inp.process_incoming_audio(_blocks(rng, 2, [32])[0], Playhead())  # new gen
    dh.sync()
    np.testing.assert_array_equal(np.asarray(dh.window(1024)), out.get_history(1024))
    dh.close()


def test_session_auto_skips_resonator():
    """device_history='auto' must not keep a ring alive that nothing reads:
    an RSNT-algorithm spectrum consumes the continuous stream, so the
    session skips the ring (and re-creates it when the algorithm flips
    back)."""
    eng = SignalizerEngine("dh-rsnt", load_default_preset=False)
    eng.spectrum.algorithm.set_normalized(1.0)  # TransformAlgorithm.RESONATOR (0.5 rounds DOWN to FFT on a 2-choice knob)
    s = AnalysisSession(eng, views=("spectrum",), axis_points=64)
    assert s._device_history is None
    eng.spectrum.algorithm.set_normalized(0.0)  # back to FFT
    s.reconfigure("spectrum")
    assert s._device_history is not None
    s.close()
    assert s._device_history is None
