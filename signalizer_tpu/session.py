"""AnalysisSession — the per-tick analysis loop over all views.

Library equivalent of the reference's editor-driven render loop
(ref: MainEditor's vsync/timer tick driving each view's onGraphicsRendering
→ the views pull the presentation stream and recompute their display
state; MainEditor.cpp tab/view ownership, CView::setApproximateRefreshRate).
One session owns an engine's view processors, keeps them in sync with the
parameter contents (the handleFlagUpdates analogue), and produces one
render-ready :class:`SessionFrame` per ``tick()``.

Typical embedding::

    eng = SignalizerEngine("my-daw-track")
    session = AnalysisSession(eng)
    while running:
        session.feed(next_audio_block, playhead)   # audio thread cadence
        frame = session.tick()                     # UI cadence (e.g. 60 Hz)
        draw(frame.line_graph, frame.oscilloscope, ...)

Every view step is wrapped in :func:`protected_call` — a fault in one
view logs and yields ``None`` for that field instead of killing the host
(ref: Protected.h-wrapped render callbacks).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

from signalizer_tpu.engine import SignalizerEngine
from signalizer_tpu.stream.audio_stream import Playhead
from signalizer_tpu.utils.exception_log import protected_call


def _pad_stereo(hist: np.ndarray) -> np.ndarray:
    """Zero-pad a mono presentation history to 2 rows (the mono
    surrogate the engine and _SgFeed apply; the RSNT/tracker paths
    crashed on 1-channel streams without it — round-3 review)."""
    if hist.shape[0] >= 2:
        return hist
    pad = np.zeros((2 - hist.shape[0], hist.shape[1]), np.float32)
    return np.concatenate([hist, pad], axis=0)


def _tracker_mags_impl(constant, frames):
    import jax.numpy as jnp

    from signalizer_tpu.kernels.spectrum import _half_spectrum, _pack_channels

    return jnp.abs(_half_spectrum(constant, _pack_channels(constant, frames)))


_tracker_mags = None  # jitted lazily (jax import cost at module import)


def _tracker_mags_jit():
    global _tracker_mags
    if _tracker_mags is None:
        import jax

        _tracker_mags = jax.jit(_tracker_mags_impl)
    return _tracker_mags

ALL_VIEWS = ("spectrum", "oscilloscope", "vectorscope", "spectrogram")


class SessionFrame(NamedTuple):
    """One render tick's outputs (fields None for inactive/failed views)."""

    spectrum: Optional[np.ndarray]  # [K, rows, P] display values
    line_graph: Optional[object]  # LineGraphFrame (vertex feed)
    oscilloscope: Optional[object]  # OscilloscopeFrame
    vectorscope: Optional[object]  # VectorscopeFrame
    spectrogram_columns: Optional[np.ndarray]  # [T, P, 4] new RGBA8 columns
    tracker: Optional[dict]  # cursor frequency readout (when enabled)
    diagnostics: dict


class AnalysisSession:
    """Owns the per-view processors of one engine and ticks them."""

    def __init__(
        self,
        engine: SignalizerEngine,
        *,
        views: Sequence[str] = ALL_VIEWS,
        axis_points: int = 1024,
        pixels: int = 1024,
        frame_rate: Optional[float] = None,
        build_line_graph: bool = True,
        cursor_fraction: Optional[float] = None,
        device_history: object = "auto",
        fused_tick: bool = True,
    ):
        self.engine = engine
        self.views = tuple(views)
        # device-resident presentation history: per tick only the NEW
        # samples cross the host->device link, and every view reads its
        # window as a static slice of the shared ring (the reference reads
        # history in place per render frame, SpectrumRendering.cpp:620-635;
        # host-path fallback kept for RSNT's continuous consumption and as
        # the device_history=False escape hatch)
        self._device_history = None
        # "auto" resolves per reconfigure() against the RESOLVED processors
        # (an RSNT spectrum consumes the continuous stream, never the ring —
        # keeping the ring alive for it would sync a dispatch per tick that
        # nothing reads); True forces the ring on, False off
        self._device_history_opt = device_history
        self.axis_points = axis_points
        self.pixels = pixels
        if frame_rate is None:
            # follow the engine's editor refresh setting (ref: the UI pump
            # timer cadence, MainEditor.cpp:393-400)
            frame_rate = 1000.0 / max(engine.editor_settings.refresh_rate_ms, 1.0)
        self.frame_rate = frame_rate
        self.build_line_graph = build_line_graph
        self.cursor_fraction = cursor_fraction
        self._last_clock = 0
        self._processors: dict = {}
        self._feeds: dict = {}
        self._sg_listener = None
        self.freeze = False  # ref: MainEditor kfreeze (hold the display)
        self._frozen_frame: Optional[SessionFrame] = None
        # one-dispatch all-views step when spectrum+oscilloscope+vectorscope
        # are all active over the device ring (views/fused_tick.py); False
        # forces the per-view path (the parity test's reference arm)
        self.fused_tick = bool(fused_tick)
        # ticks the fused step served (a caller can tell it from the
        # per-view fallback, which a protected failure also lands in)
        self.fused_tick_count = 0
        # resonator-path stream cursor + last readout (the RSNT processor
        # consumes a continuous stream, not re-read windows)
        self._res_consumed = 0
        self._res_spectrum: Optional[np.ndarray] = None
        self.reconfigure()

    # --- flag updates (ref: handleFlagUpdates rebuilds) ---------------------
    def reconfigure(self, only: Optional[str] = None) -> None:
        """(Re)build processors from the current parameter contents. Call
        after knob changes that alter shapes/modes (the engine's analogue
        of the reference's deferred flag handling)."""
        eng = self.engine
        if "spectrum" in self.views and only in (None, "spectrum"):
            proc = eng.make_spectrum_processor(
                axis_points=self.axis_points, frames_per_second=self.frame_rate
            )
            self._processors["spectrum"] = proc
            self._res_spectrum = None  # stale shape after an algo/axis change
            self._build_spectrum_feeds(proc)
        if "oscilloscope" in self.views and only in (None, "oscilloscope"):
            self._processors["oscilloscope"] = eng.make_oscilloscope_processor(
                pixels=self.pixels
            )
        if "vectorscope" in self.views and only in (None, "vectorscope"):
            self._processors["vectorscope"] = eng.make_vectorscope_processor()
        if "spectrogram" in self.views and only in (None, "spectrogram"):
            self._processors["spectrogram"] = eng.make_spectrogram_processor(
                axis_points=min(self.axis_points, 512)
            )
            # the spectrogram hopper consumes the *presentation* stream —
            # the same mixed/aligned audio every other view reads — so
            # sidechained sources appear in it too (ref: the spectrum's
            # audioEntryPoint listens on the presentation stream,
            # SpectrumDSP.cpp:210)
            if self._sg_listener is not None:
                eng.presentation_output.remove_listener(self._sg_listener)
            session = self

            class _SgFeed:
                def on_stream_audio(self, ctx, block):
                    sg = session._processors.get("spectrogram")
                    if sg is None:
                        return
                    b = np.asarray(block, np.float32)
                    if b.shape[0] < 2:  # mono surrogate like the engine
                        b = np.concatenate(
                            [b, np.zeros((2 - b.shape[0], b.shape[1]), np.float32)]
                        )
                    sg.push(b[:2])

                def on_stream_properties_changed(self, ctx, before):
                    pass

                def on_stream_died(self, ctx):
                    pass

            self._sg_listener = _SgFeed()
            eng.presentation_output.add_listener(self._sg_listener)
        self._update_device_history()

    def _ring_consumers_active(self) -> bool:
        """Does any resolved processor actually read the shared device ring?
        (oscilloscope/vectorscope always; spectrum unless the Algorithm knob
        resolved to the resonator, whose tick path consumes the continuous
        stream instead — see tick()'s RSNT branch.)"""
        if any(v in self.views for v in ("oscilloscope", "vectorscope")):
            return True
        if "spectrum" in self.views:
            from signalizer_tpu.views.spectrum import ResonatorSpectrumProcessor

            proc = self._processors.get("spectrum")
            if not isinstance(proc, ResonatorSpectrumProcessor):
                return True
            # the cursor tracker reads the ring even under RSNT display
            return self._feeds.get("tracker") is not None
        return False

    def _update_device_history(self) -> None:
        opt = self._device_history_opt
        want = self._ring_consumers_active() if opt == "auto" else bool(opt)
        if want and self._device_history is None:
            from signalizer_tpu.stream.device_history import (
                DevicePresentationHistory,
            )

            self._device_history = DevicePresentationHistory(
                self.engine.presentation_output
            )
        elif not want and self._device_history is not None:
            self._device_history.close()
            self._device_history = None

    def refresh_feeds(self) -> None:
        """Rebuild render feeds/trackers from the current contents WITHOUT
        touching any processor — no DSP state loss. The editor's light
        path for feed-tier knob edits (line colours, tracker source,
        legend toggles); the reference likewise re-reads these per frame
        rather than through handleFlagUpdates."""
        self._build_spectrum_feeds(self._processors.get("spectrum"))

    def _build_spectrum_feeds(self, proc) -> None:
        """Shared feed/tracker wiring for reconfigure() and
        refresh_feeds() — one place, so the rebuild path and the light
        feed path cannot diverge."""
        eng = self.engine
        if self.build_line_graph and proc is not None and hasattr(proc, "constant"):
            self._feeds["line_graph"] = eng.spectrum.make_render_feed(proc.constant)
            # tracker is None when FTracker = none
            self._feeds["tracker"] = (
                eng.spectrum.make_tracker(
                    eng.config.sample_rate, frame_rate=self.frame_rate
                )
                if self.cursor_fraction is not None
                else None
            )

    def processor(self, view: str):
        """The live processor behind a view ("spectrum", "oscilloscope",
        "vectorscope", "spectrogram"), or None when inactive — the public
        accessor for embedders (e.g. the spectrogram's scrolled image)."""
        return self._processors.get(view)

    def _vs_window(self) -> int:
        """Vectorscope display window, quantized to a pow2 x quarter-step
        ladder: the frame length is a jit compile key, and an unbucketed
        knob sweep would compile a fresh executable per integer value.
        <= 12.5% window error is invisible on a lissajous trail. Shared by
        the per-view path and the fused tick (identical compile keys)."""
        win = int(round(self.engine.vectorscope.window_size.get_transformed()))
        win = max(win, 64)
        qstep = max(1, (1 << (win.bit_length() - 1)) // 4)
        win = -(-win // qstep) * qstep
        # the ladder rounds UP: at the knob's top the quantized window can
        # exceed the history capacity (49152 > 48000) and the view died
        # every tick (pre-existing; exposed by the fused-parity tests)
        cap = int(self.engine.presentation_output.info.audio_history_capacity)
        return min(win, cap) if cap > 0 else win

    def _vs_meter_window(self, new_samples: int, vs_w: int) -> int:
        """pow2 bucket of the tick's new samples, clamped to the display
        window — the trailing slice the vectorscope meters integrate
        (each sample exactly once). Shared by the per-view path and the
        fused tick so both stay bit-equal."""
        n = max(int(new_samples), 1)
        return min(1 << (n - 1).bit_length(), vs_w)

    def _osc_history_len(self) -> int:
        """Samples of history the oscilloscope reads: the live window plus
        trigger search slack, bucketed to powers of two so the jit shape
        set stays small as the WindowSize knob sweeps. Shared by the
        per-view path and the fused tick (identical compile keys).
        sync_device=False: the default would device_get the Cycles
        feedback every tick — a hot-path readback that makes each tick
        wait for the previous one's device work."""
        oproc = self._processors["oscilloscope"]
        win = float(oproc.effective_window_samples(sync_device=False))
        cap = self.engine.presentation_output.info.audio_history_capacity
        return min(max(16384, 1 << int(np.ceil(np.log2(max(2.0 * win, 1.0))))), cap)

    # --- audio cadence ------------------------------------------------------
    def feed(self, block: np.ndarray, playhead: Optional[Playhead] = None) -> None:
        """Real-time audio entry: engine ingest (the spectrogram hopper is
        fed by its presentation-stream listener)."""
        self.engine.process_block(block, playhead)

    # --- UI cadence -----------------------------------------------------------
    def tick(self) -> SessionFrame:
        """One render tick: run every active view on the freshest history.

        While :attr:`freeze` is set the last frame is returned unchanged
        and the history cursor does not advance — the editor's freeze mode
        (ref: MainEditor kfreeze; a frozen view holds its display and
        resumes from live audio when unfrozen)."""
        eng = self.engine
        if self.freeze and self._frozen_frame is not None:
            # hold the display, but do NOT re-deliver the incremental
            # spectrogram delta — an embedder appending
            # ``spectrogram_columns`` each tick would duplicate columns
            f = self._frozen_frame
            if f.spectrogram_columns is not None and len(f.spectrogram_columns):
                f = f._replace(
                    spectrogram_columns=f.spectrogram_columns[:0]
                )
                self._frozen_frame = f
            return f
        clock = eng.presentation_output.sample_clock
        new_samples = max(0, clock - self._last_clock)
        self._last_clock = clock
        eng.diagnostics.tick_frame()

        spectrum = line_graph = osc = vs = cols = tracker = None
        dh = self._device_history
        # sync lazily before the first audio, but ALWAYS once the ring holds
        # data: a stream reset (clock back to 0, ring rebuilt) must re-prime
        # the mirror rather than leave views reading the pre-reset window
        if dh is not None and (clock > 0 or dh._ring is not None):
            # one hop-only upload per tick, shared by every view below;
            # a failure falls back to host-path reads for this tick
            if protected_call(dh.sync, context="device-history") is None:
                dh = None

        # WINDOW-mode oscilloscope sync rides the transport (playhead
        # position), not the free-running stream clock
        transport = float(eng._playhead.position_samples)

        if self.fused_tick and dh is not None and clock > 0:
            # one dispatch for spectrum+oscilloscope+vectorscope off the
            # shared ring; None (ineligible or a protected failure) falls
            # back to the per-view dispatches below for this tick
            from signalizer_tpu.views.fused_tick import run_fused_tick

            fused = protected_call(
                lambda: run_fused_tick(self, dh, new_samples, transport),
                context="fused-tick",
            )
            if fused is not None:
                spectrum, osc, vs = fused
                self.fused_tick_count += 1

        proc = self._processors.get("spectrum")
        if proc is not None and clock > 0:
            def run_spectrum():
                from signalizer_tpu.views.spectrum import ResonatorSpectrumProcessor

                if isinstance(proc, ResonatorSpectrumProcessor):
                    # RSNT consumes a *continuous* stream (each sample
                    # exactly once — re-reading history would double-drive
                    # the stateful bank). One tick = ONE dispatch: every
                    # pending fixed-size chunk rides a single scanned step
                    # (bucketed to powers of two + a validity mask so the
                    # jit shape set stays bounded); a sub-chunk remainder
                    # waits for the next tick.
                    chunk = 1024
                    cap = eng.presentation_output.info.audio_history_capacity
                    pending = clock - self._res_consumed
                    if pending > cap:  # overrun: the ring already lost it
                        self._res_consumed = clock - cap
                        pending = cap
                    n_chunks = pending // chunk
                    if n_chunks > 0:
                        hist = _pad_stereo(eng.get_presentation_history(pending))
                        bucket = 1 << (n_chunks - 1).bit_length()
                        blocks = np.zeros((1, 2, bucket, chunk), np.float32)
                        blocks[0, :, :n_chunks] = hist[:2, : n_chunks * chunk].reshape(
                            2, n_chunks, chunk
                        )
                        valid = np.zeros(bucket, bool)
                        valid[:n_chunks] = True
                        out = proc.process_chunks(blocks, valid)
                        self._res_consumed += n_chunks * chunk
                        self._res_spectrum = np.asarray(out)[0, -1]
                    return self._res_spectrum  # [K, rows, P] (None pre-audio)
                w = proc.constant.window_size
                if dh is not None:
                    frames = dh.window(w, lead=2, pad_to=2)
                else:
                    frames = _pad_stereo(eng.get_presentation_history(w))[None, None]
                return np.asarray(proc.process(frames))[0, -1]  # [K, rows, P]

            if spectrum is None:
                spectrum = protected_call(run_spectrum, context="spectrum")
            feed = self._feeds.get("line_graph")
            if spectrum is not None and feed is not None:
                line_graph = protected_call(
                    lambda: feed.build(spectrum[None]), context="line-graph"
                )
            trk = self._feeds.get("tracker")
            if spectrum is not None and trk is not None:
                def run_tracker():
                    from signalizer_tpu.core.constant import host_view

                    if trk.source.startswith("graph"):
                        # FTracker = Main/Aux graph: peak-search the
                        # selected graph's display row
                        k = min(int(trk.source[5:]), spectrum.shape[0] - 1)
                        return trk.update_display(
                            spectrum[k, 0],
                            host_view(proc.constant, "mapped_frequencies"),
                            self.cursor_fraction,
                            low_dbs=host_view(proc.constant, "low_dbs"),
                            high_dbs=host_view(proc.constant, "high_dbs"),
                        )
                    # FTracker = Transform: raw FFT bins — via the jitted
                    # helper (one dispatch instead of eager per-op ones)
                    w = proc.constant.window_size
                    if dh is not None:
                        frames = dh.window(w, lead=1, pad_to=2)
                    else:
                        frames = _pad_stereo(eng.get_presentation_history(w))[None]
                    mags = np.asarray(_tracker_mags_jit()(proc.constant, frames))[0, 0]
                    return trk.update(
                        mags,
                        self.cursor_fraction,
                        inv_size=float(host_view(proc.constant, "inv_size")),
                    )

                tracker = protected_call(run_tracker, context="tracker")

        oproc = self._processors.get("oscilloscope")
        if oproc is not None and clock > 0 and osc is None:

            def run_osc():
                n = self._osc_history_len()
                history = (
                    dh.window(n, lead=1)
                    if dh is not None
                    else eng.get_presentation_history(n)[None]
                )
                return oproc.process(
                    history,
                    transport_position=transport,
                    new_samples=min(new_samples, n),
                )

            osc = protected_call(run_osc, context="oscilloscope")

        vproc = self._processors.get("vectorscope")
        if vproc is not None and clock > 0 and vs is None:
            win = self._vs_window()

            def run_vs():
                if dh is not None and win <= dh.history:
                    # meters consume each sample once (audio-callback
                    # cadence): integrate only the new-samples bucket —
                    # same slice the fused tick takes (parity)
                    mw = self._vs_meter_window(new_samples, win)
                    return vproc.process(
                        dh.window(win, lead=1),
                        new_samples=new_samples,
                        meter_frames=dh.window(mw, lead=1),
                    )
                return vproc.process(
                    eng.get_presentation_history(win)[None],
                    new_samples=new_samples,
                )

            vs = protected_call(run_vs, context="vectorscope")

        sg = self._processors.get("spectrogram")
        if sg is not None:
            cols = protected_call(lambda: sg.pull(), context="spectrogram")

        frame = SessionFrame(
            spectrum=spectrum,
            line_graph=line_graph,
            oscilloscope=osc,
            vectorscope=vs,
            spectrogram_columns=cols,
            tracker=tracker,
            diagnostics=eng.diagnostics.snapshot(),
        )
        self._frozen_frame = frame
        return frame

    def close(self) -> None:
        if self._sg_listener is not None:
            self.engine.presentation_output.remove_listener(self._sg_listener)
            self._sg_listener = None
        if self._device_history is not None:
            self._device_history.close()
            self._device_history = None
        self.engine.close()
