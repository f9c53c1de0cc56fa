"""The shipped examples must keep running (CPU, subprocess-isolated)."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run(script, *args, timeout=600):
    return subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), *args],
        capture_output=True, text=True, timeout=timeout, cwd=str(ROOT),
    )


def test_demo_renders_all_views(tmp_path):
    pytest.importorskip("matplotlib")
    proc = _run("demo.py", str(tmp_path), "--cpu")
    assert proc.returncode == 0, proc.stderr[-800:]
    names = {p.name for p in tmp_path.iterdir()}
    assert {"spectrum.png", "oscilloscope.png", "vectorscope.png",
            "spectrogram.png", "session_line_graph.png"} <= names
    m = re.search(r"tracker: (\d+\.\d) Hz", proc.stdout)
    assert m and abs(float(m.group(1)) - 440.0) < 1.0, proc.stdout


def test_multichip_demo_runs():
    proc = _run("multichip_demo.py")  # default: 8-device virtual CPU mesh (--gpu: the host GPUs)
    assert proc.returncode == 0, proc.stderr[-800:]
    assert "sharded over 8 devices" in proc.stdout
    assert "global peak diagnostic" in proc.stdout


def test_preset_gallery_runs(tmp_path):
    pytest.importorskip("matplotlib")
    if not pathlib.Path("/root/reference/Make/Skeleton/presets").is_dir():
        pytest.skip("reference corpus not mounted")
    proc = _run("preset_gallery.py", str(tmp_path), "--cpu", "--limit", "3")
    assert proc.returncode == 0, proc.stderr[-800:]
    assert "3 presets" in proc.stdout
    assert any(p.suffix == ".png" for p in tmp_path.iterdir())


def test_cli_analyze_wav(tmp_path):
    """python -m signalizer_tpu analyze — the standalone-app analogue."""
    pytest.importorskip("matplotlib")
    import numpy as np
    from scipy.io import wavfile

    fs = 48000
    t = np.arange(fs) / fs
    wav = tmp_path / "tone.wav"
    stereo = np.stack([np.sin(2 * np.pi * 440 * t),
                       0.5 * np.sin(2 * np.pi * 440 * t + 0.4)], axis=1)
    wavfile.write(str(wav), fs, stereo.astype(np.float32))
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "signalizer_tpu", "--cpu", "analyze", str(wav),
         "--out", str(out), "--npz", "--axis-points", "256", "--pixels", "256"],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT),
    )
    assert proc.returncode == 0, proc.stderr[-800:]
    names = {p.name for p in out.iterdir()}
    assert {"tone.spectrum.png", "tone.oscilloscope.png",
            "tone.vectorscope.png", "tone.spectrogram.png",
            "tone.arrays.npz"} <= names
    arrays = np.load(out / "tone.arrays.npz")
    assert np.isfinite(arrays["spectrum"]).all()
    assert arrays["vertices"].shape[-1] == 3


def test_cli_analyze_batch(tmp_path):
    """N files analysed as one device batch, each rendering its own tone."""
    pytest.importorskip("matplotlib")
    import numpy as np
    from scipy.io import wavfile

    fs = 48000
    t = np.arange(fs // 2) / fs
    paths = []
    for name, f in [("x", 440.0), ("y", 2000.0)]:
        wav = tmp_path / f"{name}.wav"
        wavfile.write(str(wav), fs, np.stack(
            [np.sin(2 * np.pi * f * t)] * 2, axis=1).astype(np.float32))
        paths.append(str(wav))
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "signalizer_tpu", "--cpu", "analyze-batch",
         *paths, "--out", str(out), "--axis-points", "256"],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT),
    )
    assert proc.returncode == 0, proc.stderr[-800:]
    assert "batch-analyzed 2 files in one device batch" in proc.stdout
    assert {"x.spectrum.png", "y.spectrum.png"} <= {p.name for p in out.iterdir()}


def test_live_viewer_headless(tmp_path):
    pytest.importorskip("matplotlib")
    proc = _run("live_viewer.py", "--cpu", "--frames", "1", "--out", str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-800:]
    assert "wrote 4 frames" in proc.stdout
    names = {p.name for p in tmp_path.iterdir()}
    assert {"spectrum_00.png", "oscilloscope_00.png", "vectorscope_00.png",
            "spectrogram_00.png"} <= names


def test_embedding_host_runs():
    proc = _run("embedding_host.py", "--cpu")
    assert proc.returncode == 0, proc.stderr[-800:]
    assert "state round-trip exact: True" in proc.stdout
    m = re.search(r"tracker: (\d+\.\d) Hz", proc.stdout)
    assert m and abs(float(m.group(1)) - 440.0) < 1.0, proc.stdout


@pytest.mark.parametrize("interp", ["linear", "lanczos"])
def test_remap_bench_tool_cpu_exactness(interp):
    """The remap A/B tool's candidate formulations must stay float-exact
    against the production remap (it reads the constant's plan fields
    from host views; a plan-field rename or semantic drift breaks it)."""
    import json

    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "remap_bench.py"), "--cpu",
         "--interp", interp],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT),
    )
    assert proc.returncode == 0, proc.stderr[-800:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for key in ("maxrel_matmul", "maxrel_banded", "maxrel_both"):
        assert out[key] < 1e-5, (key, out)
