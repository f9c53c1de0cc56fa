"""Multi-chip scale-out demo: 32 channel pairs analyzed across a device
mesh through the ShardedAnalysisPipeline.

Runs anywhere: by default it builds an 8-virtual-device CPU mesh; pass
--gpu to shard over every GPU of the host instead.

Usage: python examples/multichip_demo.py [--gpu]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    import jax

    # --gpu runs on the host's GPUs; the default 8-device virtual CPU mesh
    # lets the demo run anywhere
    if "--gpu" not in sys.argv:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)

    import numpy as np

    from signalizer_tpu.core.config import (
        BinInterpolation,
        SpectrumChannels,
        ViewScaling,
    )
    from signalizer_tpu.core.constant import make_spectrum_constant
    from signalizer_tpu.parallel.mesh import make_analysis_mesh
    from signalizer_tpu.parallel.pipeline import ShardedAnalysisPipeline

    fs = 48_000.0
    mesh = make_analysis_mesh()
    n_dev = mesh.devices.size
    pairs = 4 * n_dev
    print(f"mesh: {n_dev} x {mesh.devices.flat[0].platform} devices, {pairs} channel pairs")

    constant = make_spectrum_constant(
        axis_points=512,
        window_size=2048,
        sample_rate=fs,
        configuration=SpectrumChannels.SEPARATE,
        bin_interpolation=BinInterpolation.LINEAR,
        view_scaling=ViewScaling.LOGARITHMIC,
    )
    pipe = ShardedAnalysisPipeline(
        constant, pairs=pairs, mesh=mesh, pixels=256, frames_per_tick=4
    )

    # each pair plays its own tone: pair p at 200*(p+1) Hz
    t = np.arange(2048 * 4) / fs
    block = np.stack(
        [np.sin(2 * np.pi * 200.0 * (p // 2 + 1) * t) for p in range(pairs * 2)]
    ).astype(np.float32)
    pipe.push(block)
    out = pipe.tick()
    res = np.asarray(out.results)
    print(f"results: {res.shape} sharded over {len(out.results.sharding.device_set)} devices")
    from signalizer_tpu.core.constant import host_view

    freqs = host_view(constant, "mapped_frequencies")
    for p in (0, pairs // 2, pairs - 1):
        px = int(np.argmax(res[p, -1, 0, 0]))
        print(f"  pair {p:2d}: spectral peak at {freqs[px]:7.1f} Hz "
              f"(expected {200.0 * (p + 1):7.1f})")
    print(f"global peak diagnostic (pmax across the mesh): {float(out.global_peak):.3f}")

    # the same pipeline class covers every view — scope views ingest via
    # a rolling ring instead of the frame hopper
    vs_pipe = ShardedAnalysisPipeline(
        None, pairs=pairs, mesh=mesh, view="vectorscope", history_samples=4096
    )
    vs_pipe.push(block)
    vs_out = vs_pipe.tick()
    print(
        f"vectorscope vertices {tuple(vs_out.frame.vertices.shape)} sharded over "
        f"{len(vs_out.frame.vertices.sharding.device_set)} devices, "
        f"global level {float(vs_out.global_level):.3f}"
    )

    sg_pipe = ShardedAnalysisPipeline(
        constant, pairs=pairs, mesh=mesh, view="spectrogram", frames_per_tick=2
    )
    sg_pipe.push(block)
    sg_out = sg_pipe.tick()
    print(
        f"spectrogram columns {tuple(sg_out.columns.shape)} "
        f"(pair-blended via the cross-chip psum, replicated="
        f"{sg_out.columns.sharding.is_fully_replicated})"
    )


if __name__ == "__main__":
    main()
