"""SpectrogramProcessor — streaming colour-spectrum pipeline.

The reference's ColourSpectrum display mode (ref:
Source/Spectrum/TransformDSP.inl:1163-1211 blobSize chunker +
SpectrumDSP.cpp:110-206 colour blending + SpectrumRendering.cpp:671-749
column texture updates). Here: a host-side hopper batches blob frames, the
device runs window->FFT->remap->decay->dB->gradient for ALL pending frames
in one dispatch, and a host-side scrolling image receives RGBA8 columns.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from signalizer_tpu.core.config import DisplayMode
from signalizer_tpu.core.constant import SpectrumConstant, make_spectrum_constant
from signalizer_tpu.kernels.colormap import normalize_ratios, spectrogram_columns
from signalizer_tpu.kernels.spectrum import (
    LineGraphState,
    analyze_frames,
    init_line_graph_state,
)
from signalizer_tpu.stream.batcher import FrameBatcher
from signalizer_tpu.stream.device_ring import (
    DeviceFrameSource,
    extract_frames,
    ring_update,
)

# default 5-stop gradient + background (ref: SpectrumParameters.h
# specColours defaults; exact defaults are preset-defined, these are the
# classic dark->blue->green->yellow->red heat map)
DEFAULT_GRADIENT = np.asarray(
    [
        [0.0, 0.0, 0.0],  # background
        [0.0, 0.0, 0.5],
        [0.0, 0.5, 1.0],
        [0.0, 1.0, 0.0],
        [1.0, 1.0, 0.0],
        [1.0, 0.0, 0.0],
    ],
    np.float32,
)
DEFAULT_RATIOS = np.asarray([0.0, 0.2, 0.2, 0.2, 0.2, 0.2], np.float32)


@functools.partial(jax.jit, donate_argnums=(1,))
def _spectrogram_step(
    constant: SpectrumConstant,
    state: LineGraphState,
    frames: jax.Array,
    colours: jax.Array,
    ratios: jax.Array,
    valid: jax.Array,
):
    """frames [pairs, T, C, W] -> (columns [T, P, 4] uint8, new state).

    ``valid`` [T] bool: False frames are host padding (bucketed batch
    shape); they leave the decay state untouched and their columns are
    sliced off by the caller."""
    # decay_domain="linear": spectrogram surfaces force the linear scan
    # (see post_process; decided on the previous accelerator, to be
    # re-measured on the GPU with tools/spectrogram_decay_ab.py)
    result = analyze_frames(
        constant, state, frames, valid=valid, decay_domain="linear"
    )
    # spectrogram uses the main line graph's decayed dB row
    # (ref: addAudioFrame uses LineMain, TransformDSP.inl:1144-1147)
    intensity = result.results[:, :, 0, 0, :]  # [pairs, T, P]
    cols = spectrogram_columns(intensity, colours, ratios)
    return cols, result.state


@functools.partial(jax.jit, static_argnames=("hop",), donate_argnums=(1, 2))
def _spectrogram_ring_step(
    constant: SpectrumConstant,
    ring: jax.Array,
    state: LineGraphState,
    new: jax.Array,
    n_valid: jax.Array,
    frame_valid: jax.Array,
    colours: jax.Array,
    ratios: jax.Array,
    *,
    hop: int,
):
    """Hop-only tick: shift the NEW samples [pairs, 2, t_max*hop] into the
    device-resident history ring, extract the overlapped analysis windows
    in-graph (static slices off the shift ring), analyze, colour — one
    dispatch, upload cost O(new samples) instead of O(T * window)
    (ref: prepareTransform reads windows in place from the stream ring,
    TransformDSP.inl:38-231; the host never re-copies history,
    SpectrumRendering.cpp:620-635)."""
    ring = ring_update(ring, new, n_valid)
    t_max = frame_valid.shape[0]
    frames = extract_frames(ring, constant.window_size, hop, t_max, frame_axis=-3)
    result = analyze_frames(
        constant, state, frames, valid=frame_valid, decay_domain="linear"
    )
    intensity = result.results[:, :, 0, 0, :]
    cols = spectrogram_columns(intensity, colours, ratios)
    return cols, ring, result.state


class SpectrogramProcessor:
    """Streaming spectrogram over batched channel pairs.

    ``push(block)`` feeds interleaved pair audio [pairs*2, n]; ``pull()``
    returns all newly completed RGBA8 columns [T, P, 4] (pairs blended).
    """

    def __init__(
        self,
        constant: Optional[SpectrumConstant] = None,
        *,
        pairs: int = 1,
        blob_ms: float = 10.0,  # ref: blobSize, 0.5-1000 ms
        overlap: float = 0.0,  # 0 = contiguous blobs, 0.5 = 50% overlap
        colours: Optional[np.ndarray] = None,
        ratios: Optional[np.ndarray] = None,
        image_width: int = 512,
        stretch: float = 1.0,  # ref: spectrumStretching
        device_ingest="auto",
        **constant_kwargs,
    ):
        if constant is None:
            constant_kwargs.setdefault("axis_points", 256)
            constant_kwargs.setdefault("window_size", 4096)
            constant_kwargs.setdefault("display_mode", DisplayMode.COLOUR_SPECTRUM)
            constant = make_spectrum_constant(**constant_kwargs)
        self.constant = constant
        self.pairs = pairs
        hop = max(1.0, blob_ms * 1e-3 * constant.sample_rate * (1.0 - overlap))
        if device_ingest == "auto":
            # hop-only ingest needs an integer hop (the shift ring's
            # static frame grid); sub-sample blob sizes keep the host
            # batcher. Bit-exact parity is pytest-locked either way.
            device_ingest = float(hop).is_integer()
        self.device_ingest = bool(device_ingest)
        device_ingest = self.device_ingest
        if device_ingest:
            # hop-only upload path: history lives on device; the hop is
            # quantized to integer samples (the static frame grid of the
            # shift ring — a deliberate deviation; sub-sample blob sizes
            # stay on the host batcher)
            self._source = DeviceFrameSource(
                (pairs, 2),
                constant.window_size,
                int(round(hop)),
                t_cap=32,
                max_pending_frames=max(64, int(constant.window_size * 4 / hop)),
            )
            self._ring = self._source.init_ring()
            self.batcher = self._source  # duck-typed: frames_ready/dropped
        else:
            self.batcher = FrameBatcher(
                pairs * 2,
                constant.window_size,
                hop,
                capacity=max(constant.window_size * 4, int(hop * 64)),
            )
        self._state = init_line_graph_state(constant, (pairs,))
        base = colours if colours is not None else DEFAULT_GRADIENT
        base = np.asarray(base, np.float32)
        # per-pair colour rotation (ref: generateSpectrogramColourRotation);
        # background stop shared, others hue-shifted per pair
        tables = np.stack([self._rotate(base, p, pairs) for p in range(pairs)])
        self._colours = jnp.asarray(tables)
        self._ratios = jnp.asarray(
            normalize_ratios(ratios if ratios is not None else DEFAULT_RATIOS), jnp.float32
        )
        self.image = SpectrogramImage(image_width, constant.axis_points, stretch=stretch)
        # render pacing (FrameSmoothing knob): when set, un-capped pull()s
        # consume columns through the pacer's EMA instead of all at once
        self.pacer: Optional["ColumnPacer"] = None

    @staticmethod
    def _rotate(colours: np.ndarray, pair: int, pairs: int) -> np.ndarray:
        """Hue-rotate gradient stops per pair (ref: ColourRotation,
        CommonSignalizer.h:921-954 — base.withRotatedHue(index/size))."""
        if pair == 0 or pairs <= 1:
            return colours
        import colorsys

        out = colours.copy()
        shift = pair / pairs
        for i in range(1, len(colours)):
            h, l, s = colorsys.rgb_to_hls(*colours[i])
            out[i] = colorsys.hls_to_rgb((h + shift) % 1.0, l, s)
        return out

    def push(self, block: np.ndarray) -> None:
        """Feed [pairs*2, n] audio."""
        if self.device_ingest:
            block = np.asarray(block, np.float32)
            self._source.push(block.reshape(self.pairs, 2, block.shape[-1]))
        else:
            self.batcher.push(block)

    def freshness_lag(self) -> Optional[float]:
        """Stream-clock samples between "now" and the end of the newest
        frame already emitted (None before the first frame).

        Parity evidence for the reference's preliminary-audio stitch
        (TransformDSP.inl:233-484): the reference forms a spectrogram
        frame the moment its final sample arrives by stitching history
        with the in-flight block; this framework commits each pushed
        block to the hopper before framing, so the same-push availability
        holds and the post-pull lag stays strictly below one hop
        (tests/test_spectrum_preliminary.py; bench cfg4b records the
        production-tick p50)."""
        b = self.batcher
        nf = b._next_frame
        if nf <= 0:
            return None
        if self.device_ingest:
            clock = float(b.sample_clock)
            end = float((nf - 1) * b.hop + b.window)
        else:
            clock = float(b.ring.sample_clock)
            end = float(int((nf - 1) * b.hop + 0.5) + b.window)
        return clock - end

    def pull(self, max_frames: Optional[int] = None) -> np.ndarray:
        """Process pending blobs -> RGBA8 columns [T, P, 4].

        With a ``pacer`` attached (engine wiring of the FrameSmoothing
        knob) and no explicit ``max_frames``, each call is one render tick:
        the pacer's EMA decides how many pending columns to consume so the
        scroll speed doesn't jitter with audio block boundaries.
        """
        if max_frames is None and self.pacer is not None:
            max_frames = self.pacer.columns_for_tick(self.batcher.frames_ready())
        if self.device_ingest:
            return self._pull_device(max_frames)
        frames = self.batcher.pull(max_frames)
        t = frames.shape[0]
        if t == 0:
            return np.zeros((0, self.constant.axis_points, 4), np.uint8)
        # [T, pairs*2, W] -> [pairs, T, 2, W]
        stacked = frames.reshape(t, self.pairs, 2, self.constant.window_size).transpose(1, 0, 2, 3)
        # ONE dispatch per tick: the pacer's EMA varies the pending count
        # tick to tick, and every distinct T is a fresh XLA compile — pad
        # T up to the next power of two with masked frames, so the compiled shape set stays
        # ~log2(max T) entries, the filter states stay exact (masked
        # frames are identity steps), and a tick never pays more than one
        # dispatch round trip (round-2's pow2 *decomposition* paid up to
        # log2(T) of them)
        bucket = 1 << (t - 1).bit_length()
        padded = np.zeros((self.pairs, bucket, 2, self.constant.window_size), np.float32)
        padded[:, :t] = stacked
        valid = np.zeros(bucket, bool)
        valid[:t] = True
        cols, self._state = _spectrogram_step(
            self.constant,
            self._state,
            jnp.asarray(padded),
            self._colours,
            self._ratios,
            jnp.asarray(valid),
        )
        cols = np.asarray(cols)[:t]
        self.image.push_columns(cols)
        return cols

    def _pull_device(self, max_frames: Optional[int]) -> np.ndarray:
        """Hop-only tick: each upload unit moves only NEW samples to the
        device; windows come from the resident ring in-graph."""
        out = []
        for unit in self._source.pull_uploads(max_frames):
            cols, self._ring, self._state = _spectrogram_ring_step(
                self.constant,
                self._ring,
                self._state,
                jnp.asarray(unit.samples),
                jnp.int32(unit.n_valid),
                jnp.asarray(unit.frame_valid),
                self._colours,
                self._ratios,
                hop=self._source.hop,
            )
            if unit.t_valid:
                out.append(np.asarray(cols)[unit.frame_valid])
        if not out:
            return np.zeros((0, self.constant.axis_points, 4), np.uint8)
        cols = np.concatenate(out, axis=0)
        self.image.push_columns(cols)
        return cols

    def reset(self) -> None:
        self._state = init_line_graph_state(self.constant, (self.pairs,))
        if self.device_ingest:
            self._ring = self._source.init_ring()


class SpectrogramImage:
    """Host-side circularly-scrolled column image (ref: cpl COpenGLImage
    scroll + updateSingleColumn usage, SpectrumRendering.cpp:671-749).

    ``stretch`` emulates the SpectrumStretch knob (ref: Spectrum.cpp:509 —
    the GL image is resized to viewWidth / stretch, so each DSP column
    covers ``stretch`` display pixels): the backing store holds
    ``width / stretch`` columns and :meth:`snapshot` repeats each one
    ``stretch`` times back to the display width.
    """

    def __init__(self, width: int, height: int, stretch: float = 1.0):
        self.display_width = width
        self.stretch = max(1, int(round(stretch)))
        self.width = max(1, int(round(width / self.stretch)))
        self.height = height
        self._img = np.zeros((self.width, height, 4), np.uint8)
        self._img[..., 3] = 255
        self._cursor = 0

    def push_columns(self, cols: np.ndarray) -> None:
        """cols [T, height, 4]."""
        t = cols.shape[0]
        if t >= self.width:
            self._img[:] = cols[-self.width :]
            self._cursor = 0
            return
        first = min(t, self.width - self._cursor)
        self._img[self._cursor : self._cursor + first] = cols[:first]
        rest = t - first
        if rest:
            self._img[:rest] = cols[first:]
        self._cursor = (self._cursor + t) % self.width

    def push_debug_checkerboard(self, columns: int = 8) -> None:
        """Inject a checkerboard test pattern into the column upload path
        (ref: SIGNALIZER_VISUALDEBUGTEST, SpectrumRendering.cpp:705-719 —
        verifies column ordering/scroll/stretch visually)."""
        t = np.arange(columns)[:, None]
        f = np.arange(self.height)[None, :]
        checker = (((t // 2) + (f // 8)) % 2).astype(np.uint8) * 255
        cols = np.zeros((columns, self.height, 4), np.uint8)
        cols[..., 0] = checker
        cols[..., 1] = checker
        cols[..., 2] = checker
        cols[..., 3] = 255
        self.push_columns(cols)

    def snapshot(self) -> np.ndarray:
        """Time-ordered image [display_width, height, 4], oldest column
        first; each stored column repeated ``stretch`` times."""
        img = np.roll(self._img, -self._cursor, axis=0)
        if self.stretch > 1:
            img = np.repeat(img, self.stretch, axis=0)[: self.display_width]
        return img


class ColumnPacer:
    """Render-rate smoothing for spectrogram columns
    (ref: framesPerUpdate EMA in renderColourSpectrum,
    SpectrumRendering.cpp:671-749): smooths how many DSP columns each
    render tick consumes so the scroll speed doesn't jitter with audio
    block boundaries."""

    def __init__(self, smoothing: float = 0.9):
        self.smoothing = float(smoothing)
        self._per_update = 0.0
        self._debt = 0.0

    def columns_for_tick(self, available: int) -> int:
        """How many of ``available`` pending columns to consume this tick."""
        self._per_update = (
            self.smoothing * self._per_update + (1.0 - self.smoothing) * available
        )
        want = self._per_update + self._debt
        take = int(want)
        take = max(0, min(take, available))
        self._debt = want - take
        # never fall behind more than one tick's worth
        if available - take > self._per_update * 2:
            take = available
            self._debt = 0.0
        return take
