"""signalizer_tpu — an accelerator audio analysis & visualization framework.

A ground-up JAX/XLA rebuild of the capabilities of
jthorborg/signalizer (reference: /root/reference, v0.4.3): the Spectrum,
Oscilloscope and Vectorscope analysis engines, the multi-instance audio
streaming/mixing layer, the parameter system and the versioned state
serialization — re-designed for a batched accelerator:

* every DSP core is a batched, jit-compiled function over
  ``[batch, channels, samples]`` frames (the reference's per-channel-pair
  ``parallel_for`` becomes a batch axis),
* reconfiguration follows the reference's ``TransformConstant`` split
  (ref: Source/Spectrum/TransformConstant.h): static shapes live in the
  jit key, precomputed arrays (window kernels, frequency maps, gather
  plans) are pytree leaves,
* multi-chip scaling is data-parallel over frames/streams via
  ``jax.sharding`` meshes (see :mod:`signalizer_tpu.parallel`).

Package layout:

* :mod:`signalizer_tpu.core`    — dtypes, window family, dB scaling, constants
* :mod:`signalizer_tpu.kernels` — the jittable DSP kernels (FFT frame pipeline,
  frequency remap, peak decay, resonator bank, triggers, sinc resampling,
  min-max decimation, vectorscope transforms, colour maps)
* :mod:`signalizer_tpu.views`   — Spectrum / Oscilloscope / Vectorscope
  processors (the reference's view DSP cores, minus OpenGL)
* :mod:`signalizer_tpu.stream`  — host-side streaming: ring buffers,
  AudioStream, frame batcher, mix graph (multi-instance alignment)
* :mod:`signalizer_tpu.params`  — the parameter system (transformers,
  formatters, parameter sets)
* :mod:`signalizer_tpu.state`   — versioned keyed-tree serialization & presets
* :mod:`signalizer_tpu.parallel`— device-mesh sharding helpers
"""

__version__ = "0.1.0"

from signalizer_tpu.core.config import (  # noqa: F401
    SpectrumChannels,
    OscChannels,
    BinInterpolation,
    ViewScaling,
    DisplayMode,
    TransformAlgorithm,
    MAX_INPUT_CHANNELS,
    STREAM_PACKET_SIZE,
)
