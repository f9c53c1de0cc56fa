"""End-to-end demo: feed a synthetic mix through one engine and render all
four views to PNG.

Usage: python examples/demo.py [out_dir] [--cpu]

--cpu forces the CPU backend via jax.config (the same as running with
JAX_PLATFORMS=cpu).
"""

import pathlib
import sys

# runnable from anywhere: put the repo root on the path
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from signalizer_tpu.engine import SignalizerEngine
from signalizer_tpu.views.render import (
    render_oscilloscope,
    render_spectrogram,
    render_spectrum,
    render_vectorscope,
)


def main(out_dir="demo_out"):
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    fs = 48_000.0
    eng = SignalizerEngine("demo")

    t = np.arange(int(2 * fs)) / fs
    rng = np.random.default_rng(0)
    melody = 0.5 * np.sin(2 * np.pi * 440 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
    high = 0.15 * np.sin(2 * np.pi * 2500 * t)
    noise = 0.02 * rng.standard_normal(len(t))
    left = (melody + high + noise).astype(np.float32)
    right = np.roll(left, 9) * 0.8
    eng.process_block(np.stack([left, right]))

    from signalizer_tpu.core.constant import host_view

    sp = eng.make_spectrum_processor(axis_points=800)
    res = sp.process(eng.get_presentation_history(sp.constant.window_size)[None])
    render_spectrum(
        np.asarray(res)[0, 0, 0],
        host_view(sp.constant, "mapped_frequencies"),
        path=out / "spectrum.png",
    )

    osc = eng.make_oscilloscope_processor(pixels=800)
    render_oscilloscope(osc.process(eng.get_presentation_history(16384)[None]), path=out / "oscilloscope.png")

    vs = eng.make_vectorscope_processor()
    render_vectorscope(vs.process(eng.get_presentation_history(4096)[None]), path=out / "vectorscope.png")

    sg = eng.make_spectrogram_processor(axis_points=160, image_width=180)
    sg.push(np.stack([left, right]))
    sg.pull()
    render_spectrogram(sg.image, path=out / "spectrogram.png")

    # the session loop: all four views per tick, one API
    from signalizer_tpu.session import AnalysisSession
    from signalizer_tpu.views.render import render_line_graph_frame

    session_engine = SignalizerEngine("session-demo")
    session_engine.spectrum.frequency_tracker.set_normalized(1 / 3)  # transform
    session = AnalysisSession(
        session_engine, axis_points=400, pixels=400,
        cursor_fraction=440.0 / (fs / 2),
    )
    chunk = int(fs * 0.25)
    for i in range(8):
        session.feed(np.stack([left, right])[:, i * chunk : (i + 1) * chunk])
        frame = session.tick()
    if frame.line_graph is not None:
        render_line_graph_frame(frame.line_graph, path=out / "session_line_graph.png")
    if frame.tracker is not None:
        print(f"  tracker: {frame.tracker['frequency']:.1f} Hz ({frame.tracker['note']})")
    session.close()
    print(f"wrote 4 renders to {out}/")
    eng.close()


if __name__ == "__main__":
    args = [a for a in sys.argv[1:]]
    if "--cpu" in args:
        args.remove("--cpu")
        import jax

        jax.config.update("jax_platforms", "cpu")
    main(*args[:1])
