"""AudioStream — producer/consumer audio transport with history.

Host-side equivalent of cpl's ``AudioStream<float, 256>``
(ref: usage inventory SURVEY.md §2.9; typedef at
Source/Config/SignalizerConfiguration.h:60): a single Input (the real-time
producer), an Output with listeners (async consumers) and a retained
history ring for windowed re-reads, plus performance counters.

Re-design notes: the reference packetizes into a lock-free SPSC queue and
wakes a dedicated consumer thread (the visualization DSP ran on CPU beside
the audio thread). Here consumers run DSP on the accelerator, so the host layer's
job is only to (a) decouple the producer from consumers and (b) retain
history. ``threaded=True`` reproduces the async-consumer-thread behavior:
blocks are packetized at ``STREAM_PACKET_SIZE`` (ref: AudioStream<float,
256>) into the **native lock-free SPSC packet queue**
(signalizer_tpu/native/host_runtime.cpp sz_pq_* — the readerwriterqueue analogue; pushes
are wait-free and allocation-free so the producer path is realtime-safe),
falling back to a Python queue when no compiler is available.
``threaded=False`` delivers synchronously — useful for deterministic
tests and offline analysis.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Protocol

import numpy as np

from signalizer_tpu.core.config import DEFAULT_HISTORY_SIZE, STREAM_PACKET_SIZE
from signalizer_tpu.stream.ring_buffer import make_ring_buffer
from signalizer_tpu.utils.exception_log import protected_call


@dataclass
class Playhead:
    """Transport snapshot (ref: cpl Playhead — getPositionInSamples,
    getSteadyClock, getBPM, isPlaying)."""

    position_samples: int = 0
    steady_clock: int = 0
    bpm: float = 120.0
    is_playing: bool = False

    def advanced(self, n: int) -> "Playhead":
        return Playhead(
            position_samples=self.position_samples + (n if self.is_playing else 0),
            steady_clock=self.steady_clock + n,
            bpm=self.bpm,
            is_playing=self.is_playing,
        )


@dataclass
class AudioStreamInfo:
    """Stream properties (ref: cpl AudioStreamInfo / ProducerInfo)."""

    channels: int = 2
    sample_rate: float = 48_000.0
    anticipated_size: int = STREAM_PACKET_SIZE
    audio_history_size: int = DEFAULT_HISTORY_SIZE
    audio_history_capacity: int = DEFAULT_HISTORY_SIZE
    channel_names: List[str] = field(default_factory=list)


@dataclass
class PerfMeasures:
    """ref: AudioStream::getPerfMeasures — producer/consumer usage AND
    overhead percentages plus dropped frames, the numbers the reference's
    diagnostics HUD prints (SpectrumRendering.cpp:163-184).

    Usage/overhead are fractions of the *real-time budget* (block duration
    at the stream sample rate), EMA-smoothed: ``usage`` is time spent doing
    useful work (history write + listener DSP), ``overhead`` is time spent
    inside the transport machinery itself (packetization, queue push/pop).
    """

    producer_usage: float = 0.0
    producer_overhead: float = 0.0
    consumer_usage: float = 0.0
    consumer_overhead: float = 0.0
    dropped_frames: int = 0
    in_flight_packets: int = 0


_PERF_EMA = 0.9  # ~10-block smoothing, like the reference's CBoxFilter HUD


def _ema(prev: float, value: float) -> float:
    return _PERF_EMA * prev + (1.0 - _PERF_EMA) * value


class StreamListener(Protocol):
    """ref: cpl AudioStream::Listener.

    Lifetime contract (same as the reference's buffer views): ``block`` is
    only valid DURING the callback — producers may reuse the underlying
    buffer (e.g. the mix graph's scratch matrix) afterwards. Copy it if
    you keep it."""

    def on_stream_audio(self, ctx: "ListenerContext", block: np.ndarray) -> None: ...

    def on_stream_properties_changed(
        self, ctx: "ListenerContext", before: AudioStreamInfo
    ) -> None: ...

    def on_stream_died(self, ctx: "ListenerContext") -> None: ...


class ListenerContext:
    """Delivered with every callback (ref: cpl ListenerContext).

    ``block_end_clock``/``ring_generation`` identify the delivered block's
    exact position on the history ring's monotonic sample clock (stamped by
    the producer at write time; the clock restarts whenever the generation
    changes). ``None`` for callbacks that carry no block (properties/died)."""

    def __init__(
        self,
        output: "AudioStreamOutput",
        playhead: Playhead,
        block_end_clock: Optional[int] = None,
        ring_generation: Optional[int] = None,
    ):
        self._output = output
        self.playhead = playhead
        self.block_end_clock = block_end_clock
        self.ring_generation = ring_generation

    @property
    def info(self) -> AudioStreamInfo:
        return self._output.info

    def get_history(self, n: int) -> np.ndarray:
        """Windowed re-read of retained history [channels, n]
        (ref: getAudioBufferViews)."""
        return self._output.get_history(n)


class AudioStreamOutput:
    """Consumer side: listener registry + history ring + perf counters."""

    def __init__(self, stream: "AudioStream"):
        self._stream = stream
        self._listeners: List[StreamListener] = []
        self._lock = threading.Lock()

    @property
    def info(self) -> AudioStreamInfo:
        return self._stream.info

    def add_listener(self, listener: StreamListener) -> None:
        with self._lock:
            self._listeners.append(listener)

    def remove_listener(self, listener: StreamListener) -> None:
        with self._lock:
            if listener in self._listeners:
                self._listeners.remove(listener)

    def modify_consumer_info(self, fn) -> None:
        """Adjust history sizing (ref: modifyConsumerInfo —
        storeAudioHistory / audioHistorySize)."""
        fn(self._stream.info)
        self._stream._resize_history()

    def get_history(self, n: int) -> np.ndarray:
        return self._stream._history.latest(n)

    @property
    def sample_clock(self) -> int:
        return self._stream._history.sample_clock

    @property
    def ring_generation(self) -> int:
        """Clock-domain id: bumps whenever the history ring is rebuilt."""
        return self._stream._ring_generation

    def history_snapshot(self, n: int):
        """Atomic ``(window, end_clock, generation)`` of the trailing
        history: the window ends EXACTLY at the returned clock. A concurrent
        producer write during the copy is detected by the clock/generation
        moving and retried (clock-level seqlock); with an audio-rate
        producer the copy is orders of magnitude faster than the block
        interval, so retries are vanishingly rare."""
        data = None
        for _ in range(16):
            g0 = self._stream._ring_generation
            c0 = self._stream._history.sample_clock
            data = self._stream._history.latest(n)
            if (
                self._stream._history.sample_clock == c0
                and self._stream._ring_generation == g0
            ):
                return data, c0, g0
        # pathological contention: return the last copy with its post-copy
        # clock — over-stating the clock can only drop (not duplicate) a
        # block that raced the final copy; the gap detector re-primes then
        return data, self._stream._history.sample_clock, self._stream._ring_generation

    def get_perf_measures(self) -> PerfMeasures:
        return self._stream._perf

    # internal
    def _deliver(
        self,
        block: np.ndarray,
        playhead: Playhead,
        end_clock: Optional[int] = None,
        generation: Optional[int] = None,
    ) -> None:
        ctx = ListenerContext(self, playhead, end_clock, generation)
        with self._lock:
            listeners = list(self._listeners)
        for l in listeners:
            # per-listener containment (ref: Protected.h-wrapped callbacks):
            # one faulty listener must neither kill the delivery thread nor
            # starve the listeners after it — and in sync mode it must not
            # propagate into another engine's audio path
            protected_call(
                lambda l=l: l.on_stream_audio(ctx, block),
                context="stream-listener",
            )

    def _properties_changed(self, before: AudioStreamInfo) -> None:
        ctx = ListenerContext(self, self._stream._playhead)
        with self._lock:
            listeners = list(self._listeners)
        for l in listeners:
            # same containment contract as _deliver: a faulty listener
            # must not starve later listeners of the geometry change nor
            # raise into the producer's initialize_info path
            protected_call(
                lambda l=l: l.on_stream_properties_changed(ctx, before),
                context="stream-listener-properties",
            )

    def _died(self) -> None:
        ctx = ListenerContext(self, self._stream._playhead)
        with self._lock:
            listeners = list(self._listeners)
        for l in listeners:
            protected_call(
                lambda l=l: l.on_stream_died(ctx),
                context="stream-listener-died",
            )


class AudioStreamInput:
    """Producer side (ref: AudioStream::Input)."""

    def __init__(self, stream: "AudioStream"):
        self._stream = stream

    def initialize_info(self, fn) -> None:
        snap = dict(vars(self._stream.info))
        # the list is mutable — aliasing it would let fn's edits bleed
        # into the 'before' snapshot listeners diff against
        snap["channel_names"] = list(snap["channel_names"])
        before = AudioStreamInfo(**snap)
        fn(self._stream.info)
        self._stream._resize_history()
        self._stream.output._properties_changed(before)

    def enqueue_channel_name(self, index: int, name: str) -> None:
        names = self._stream.info.channel_names
        while len(names) <= index:
            names.append(f"channel {len(names)}")
        names[index] = name

    def is_anyone_listening(self) -> bool:
        return bool(self._stream.output._listeners)

    def process_incoming_audio(self, block: np.ndarray, playhead: Optional[Playhead] = None) -> None:
        """Real-time entry (ref: processIncomingRTAudio)."""
        self._stream._ingest(np.asarray(block, np.float32), playhead)


class AudioStream:
    """Factory + plumbing. ``AudioStream.create(threaded)`` returns
    ``(input, output)`` (ref: AudioStream::create)."""

    def __init__(self, threaded: bool, info: Optional[AudioStreamInfo] = None):
        self.info = info or AudioStreamInfo()
        self._history = make_ring_buffer(self.info.channels, max(self.info.audio_history_capacity, 1))
        # bumped whenever the history ring is rebuilt (its sample clock
        # resets): listeners keying state on block end clocks use the
        # generation to detect that the clock domain changed underneath them
        self._ring_generation = 0
        self._playhead = Playhead()
        self._perf = PerfMeasures()
        self.output = AudioStreamOutput(self)
        self.input = AudioStreamInput(self)
        self._threaded = threaded
        self._queue: Optional[queue.Queue] = None
        self._native_queue = None
        # single-writer drain counters: producer bumps _pushed, the worker
        # bumps _delivered — no lock needed for the drained test
        self._pushed = 0
        self._delivered = 0
        self._worker: Optional[threading.Thread] = None
        self._alive = True
        if threaded:
            try:
                from signalizer_tpu.native_bindings import (
                    NativePacketQueue,
                    native_available,
                )

                if native_available():
                    self._native_queue = NativePacketQueue(
                        self.info.channels, STREAM_PACKET_SIZE, capacity=256
                    )
            except Exception:  # pragma: no cover — fall back to python
                self._native_queue = None
            if self._native_queue is None:
                self._queue = queue.Queue(maxsize=256)
            self._worker = threading.Thread(target=self._run, daemon=True, name="audio-stream")
            self._worker.start()

    @classmethod
    def create(cls, threaded: bool = False, info: Optional[AudioStreamInfo] = None):
        stream = cls(threaded, info)
        return stream.input, stream.output

    def _resize_history(self) -> None:
        cap = max(self.info.audio_history_capacity, 1)
        if cap != self._history.capacity or self.info.channels != self._history.channels:
            self._history = make_ring_buffer(self.info.channels, cap)
            self._ring_generation += 1  # fresh ring: sample clock restarted
        # the native packet queue's slot geometry is channel-count bound:
        # feeding a reshaped stream into the old queue would make the
        # native copy read past the block
        if (
            self._native_queue is not None
            and self._native_queue.channels != self.info.channels
        ):
            from signalizer_tpu.native_bindings import NativePacketQueue

            old = self._native_queue
            self._native_queue = NativePacketQueue(
                self.info.channels, STREAM_PACKET_SIZE, capacity=256
            )
            # the worker drains the closed queue to its closed-and-drained
            # signal before switching (see _run), so every pushed packet
            # still delivers — the drain counters stay consistent with no
            # re-anchoring (an earlier re-anchor here let wait_for_drain
            # return while new-queue packets were in flight). The explicit
            # successor pointer (set BEFORE close, so the worker observing
            # closed-and-drained always sees it) makes the worker walk
            # swapped-out queues in swap ORDER: jumping straight to the
            # CURRENT queue after two quick swaps stranded any packets
            # pushed to the intermediate one (advisor finding, round 3).
            old._swap_next = self._native_queue
            old.close()

    def _ingest(self, block: np.ndarray, playhead: Optional[Playhead]) -> None:
        if not self._alive:
            return
        t0 = time.perf_counter()
        if block.shape[0] != self.info.channels:
            # adapt (mono -> stereo surrogate etc.; ref: PluginProcessor
            # mono handling :179-193)
            fixed = np.zeros((self.info.channels, block.shape[1]), np.float32)
            fixed[: min(block.shape[0], self.info.channels)] = block[: self.info.channels]
            block = fixed
        self._history.write(block)
        # exact ring clock at this block's last sample + the clock domain's
        # generation, stamped at WRITE time (single producer): listeners
        # that mirror the ring (stream/device_history.py) dedup and
        # gap-check deliveries against these, closing the written-but-not-
        # yet-delivered races a delivery-time clock read cannot
        end_clock = self._history.sample_clock
        gen = self._ring_generation
        ph = playhead or self._playhead
        self._playhead = ph.advanced(block.shape[1])
        budget = block.shape[1] / max(self.info.sample_rate, 1.0)
        t_q0 = time.perf_counter()
        if self._threaded:
            if self._native_queue is not None:
                # packetize at STREAM_PACKET_SIZE (ref: AudioStream<_, 256>);
                # each push is a wait-free native copy
                pkt_ph = ph
                pkt_end = end_clock - block.shape[1]
                for start in range(0, block.shape[1], STREAM_PACKET_SIZE):
                    chunk = block[:, start : start + STREAM_PACKET_SIZE]
                    pkt_end += chunk.shape[1]
                    ok = self._native_queue.push(
                        chunk,
                        pkt_ph.position_samples,
                        pkt_ph.steady_clock,
                        pkt_ph.bpm,
                        pkt_ph.is_playing,
                        end_clock=pkt_end,
                        generation=gen,
                    )
                    if ok:
                        self._pushed += 1
                    else:
                        self._perf.dropped_frames += 1
                    pkt_ph = pkt_ph.advanced(chunk.shape[1])
                self._perf.in_flight_packets = self._native_queue.size
            else:
                try:
                    # copy: callers may reuse the block buffer (e.g. the
                    # mix graph's scratch) before the worker delivers it —
                    # the native queue copies by construction
                    self._queue.put_nowait((block.copy(), ph, end_clock, gen))
                    self._pushed += 1
                    self._perf.in_flight_packets = self._queue.qsize()
                except queue.Full:
                    self._perf.dropped_frames += 1
        else:
            self.output._deliver(block, ph, end_clock, gen)
        now = time.perf_counter()
        # threaded: everything after t_q0 is transport machinery (the
        # listener DSP happens on the worker thread). sync: delivery IS the
        # work — machinery is effectively zero, and the consumer counters
        # are updated here since there is no worker.
        if self._threaded:
            self._perf.producer_overhead = _ema(
                self._perf.producer_overhead, (now - t_q0) / budget
            )
        else:
            self._perf.consumer_usage = _ema(
                self._perf.consumer_usage, (now - t_q0) / budget
            )
        self._perf.producer_usage = _ema(self._perf.producer_usage, (now - t0) / budget)

    def _run(self) -> None:
        if self._native_queue is not None:
            q = self._native_queue
            while True:
                # pop time counts as machinery overhead only when a packet
                # was already waiting — blocking on an empty queue is idle
                qsize = q.size
                t_pop0 = time.perf_counter()
                try:
                    # keep draining THIS queue object until its
                    # closed-and-drained signal: on a geometry swap the
                    # old queue's remaining packets must all deliver (the
                    # drain counters assume every pushed packet is
                    # eventually delivered) before switching to the new
                    # queue — re-reading self._native_queue per pop
                    # stranded them (round-3 review)
                    item = q.pop(timeout_ms=100)
                except StopIteration:
                    # closed-and-drained: shutting down (no successor), or
                    # swapped for a new channel geometry — follow the swap
                    # CHAIN in order, so packets pushed to an intermediate
                    # queue between two quick swaps still deliver
                    nxt = getattr(q, "_swap_next", None)
                    if nxt is None:
                        return
                    q = nxt
                    continue
                if item is None:
                    continue
                chunk, position, steady, bpm, playing, end_clock, gen = item
                pop_time = (time.perf_counter() - t_pop0) if qsize > 0 else 0.0
                ph = Playhead(
                    position_samples=position,
                    steady_clock=steady,
                    bpm=bpm,
                    is_playing=playing,
                )
                budget = chunk.shape[1] / max(self.info.sample_rate, 1.0)
                t0 = time.perf_counter()
                try:
                    # a listener fault must not kill the delivery thread —
                    # the stream would silently stop forever (the reference
                    # wraps callbacks in Protected.h for the same reason)
                    protected_call(
                        lambda: self.output._deliver(chunk, ph, end_clock, gen),
                        context="stream-deliver",
                    )
                finally:
                    self._delivered += 1
                self._perf.consumer_usage = _ema(
                    self._perf.consumer_usage, (time.perf_counter() - t0) / budget
                )
                self._perf.consumer_overhead = _ema(
                    self._perf.consumer_overhead, pop_time / budget
                )
                self._perf.in_flight_packets = self._native_queue.size
            return
        while True:
            qsize = self._queue.qsize()
            t_pop0 = time.perf_counter()
            item = self._queue.get()
            if item is None:
                return
            pop_time = (time.perf_counter() - t_pop0) if qsize > 0 else 0.0
            block, ph, end_clock, gen = item
            budget = block.shape[1] / max(self.info.sample_rate, 1.0)
            t0 = time.perf_counter()
            try:
                protected_call(
                    lambda: self.output._deliver(block, ph, end_clock, gen),
                    context="stream-deliver",
                )
            finally:
                self._delivered += 1
            self._perf.consumer_usage = _ema(
                self._perf.consumer_usage, (time.perf_counter() - t0) / budget
            )
            self._perf.consumer_overhead = _ema(
                self._perf.consumer_overhead, pop_time / budget
            )
            self._perf.in_flight_packets = self._queue.qsize()

    def close(self) -> None:
        self._alive = False
        if self._threaded:
            if self._native_queue is not None:
                self.wait_for_drain(timeout=1.0)
                self._native_queue.close()
            elif self._queue is not None:
                self._queue.put(None)
            self._worker.join(timeout=2)
        self.output._died()

    def wait_for_drain(self, timeout: float = 5.0) -> bool:
        """Block until all queued packets were delivered (test helper).

        Uses two single-writer monotonic counters (producer ``_pushed``,
        consumer ``_delivered``) — an emptiness probe races the window
        between pop() and delivery and can report drained mid-packet."""
        if not self._threaded:
            return True
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self._delivered >= self._pushed:
                return True
            time.sleep(0.001)
        return False
