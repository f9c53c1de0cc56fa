"""FramePipeline — depth-N in-flight dispatch pipelining.

The reference decouples DSP from display with a 10-deep lock-free frame
queue (ref: Spectrum::SFrameQueue, Source/Spectrum/Spectrum.h:139-143):
the audio thread keeps producing while the render thread consumes
whatever is READY, so neither ever waits on the other's latency. This
embodiment keeps up to ``depth`` analysis steps in flight —
the host->device upload of frame t+1 overlaps the device compute of
frame t — and mirrors the reference's non-blocking consumption exactly:
completion is detected with ``Array.is_ready()``, a LOCAL check backed
by asynchronous completion notifications, never with a per-frame
``block_until_ready``.

Why not block: a per-frame ``block_until_ready`` makes the producer wait
for each frame's device work, so uploads and compute stop overlapping;
polling ``is_ready`` is a cheap host check, and the host keeps submitting
while completions arrive. Whether this pays on a local GPU against the
simple blocking loop is not measured yet (bench ``pipeline`` keys).
Blocking is reserved for BACKPRESSURE: when more than ``depth`` frames
are in flight, ``submit`` blocks on the oldest (the reference's
bounded queue keeps the producer from racing ahead the same way).

Usage::

    pipe = FramePipeline(step_fn, state0, depth=32)
    for block in audio_blocks:
        for done in pipe.submit(block):   # 0+ completed outputs, in order
            display(done)
    for done in pipe.drain():
        display(done)

``step_fn(state, frame) -> (output, new_state)`` must be jitted; state
is threaded internally (donation-safe: the pipeline never re-reads an
old state).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Iterable, List, Tuple

import jax


def _ready(out: Any) -> bool:
    """True when every array leaf of ``out`` has completed (local check)."""
    for leaf in jax.tree_util.tree_leaves(out):
        is_ready = getattr(leaf, "is_ready", None)
        if is_ready is not None and not is_ready():
            return False
    return True


class FramePipeline:
    """Keep up to ``depth`` jitted steps in flight, harvesting completed
    outputs non-blockingly (ref: the 10-deep SFrameQueue; the consumer
    only ever takes what is ready)."""

    def __init__(
        self,
        step_fn: Callable[[Any, Any], Tuple[Any, Any]],
        state: Any = None,
        *,
        depth: int = 32,
    ):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.step_fn = step_fn
        self.state = state
        self.depth = depth
        self._inflight: deque = deque()
        self.frames_submitted = 0
        self.frames_completed = 0

    def submit(self, frame) -> List[Any]:
        """Dispatch one frame asynchronously. Returns every output that
        has completed (possibly none), oldest first; blocks only if more
        than ``depth`` frames would remain in flight."""
        dev = jax.device_put(frame)  # async H2D — overlaps device compute
        out, self.state = self.step_fn(self.state, dev)
        self._inflight.append(out)
        self.frames_submitted += 1
        done = self.harvest()
        while len(self._inflight) > self.depth:  # backpressure
            done.append(self._pop_blocking())
        return done

    def harvest(self) -> List[Any]:
        """Pop and return the leading run of completed outputs without
        blocking (completion order is submission order: device execution
        is FIFO)."""
        done = []
        while self._inflight and _ready(self._inflight[0]):
            done.append(self._inflight.popleft())
            self.frames_completed += 1
        return done

    def _pop_blocking(self, poll_s: float = 0.002):
        out = self._inflight.popleft()
        jax.block_until_ready(out)
        # a completed output must also read as ready, so the depth bound
        # and the frames_completed count hold on every backend
        while not _ready(out):
            time.sleep(poll_s)
        self.frames_completed += 1
        return out

    @property
    def in_flight(self) -> int:
        return len(self._inflight)

    def drain(self, poll_s: float = 0.001, timeout_s: float = 10.0) -> List[Any]:
        """Complete and return every in-flight output (end of stream).
        Polls readiness; falls back to blocking pops if nothing completes
        within ``timeout_s``."""
        outs = []
        deadline = time.monotonic() + timeout_s
        while self._inflight:
            got = self.harvest()
            if got:
                outs.extend(got)
                deadline = time.monotonic() + timeout_s
            elif time.monotonic() > deadline:
                outs.append(self._pop_blocking())
            else:
                time.sleep(poll_s)
        return outs

    def run(self, frames: Iterable[Any]) -> Iterable[Any]:
        """Convenience: pipeline an iterable of frames, yielding outputs
        in submission order as they complete."""
        for f in frames:
            yield from self.submit(f)
        yield from self.drain()
