"""Compile-cache placement and the nvidia-smi parser (signalizer_tpu.utils.device)."""

import pytest

from signalizer_tpu.utils import device as dv


def test_cache_dir_from_environment_wins():
    path, from_env = dv.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/somewhere/cache"})
    assert (path, from_env) == ("/somewhere/cache", True)


def test_cache_dir_defaults_to_fixed_checkout_path():
    path, from_env = dv.compile_cache_dir({})
    assert not from_env
    assert path == str(dv.CHECKOUT_ROOT / ".jax_cache")
    # fixed: the same answer every call (a moving path never hits)
    assert dv.compile_cache_dir({})[0] == path
    assert (dv.CHECKOUT_ROOT / "signalizer_tpu").is_dir()


def test_enable_sets_nothing_when_environment_chooses(monkeypatch):
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/env/cache")
    assert dv.enable_compile_cache() == "/env/cache"
    assert calls == []


def test_enable_points_jax_at_checkout_cache(monkeypatch):
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = dv.enable_compile_cache()
    assert path.endswith(".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


@pytest.mark.parametrize(
    "text,want",
    [
        ("NVIDIA H100 80GB HBM3, 700.00 W\n",
         [("NVIDIA H100 80GB HBM3", "700.00 W", 700.0)]),
        ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 700.00 W\n\n",
         [("NVIDIA H100 80GB HBM3", "500.00 W", 500.0),
          ("NVIDIA H100 80GB HBM3", "700.00 W", 700.0)]),
        ("Some, Card, [N/A]\n", [("Some, Card", "[N/A]", None)]),
        ("", []),
    ],
)
def test_parse_nvidia_smi(text, want):
    got = dv.parse_nvidia_smi(text)
    assert [(c["name"], c["power_limit"], c["power_limit_w"]) for c in got] == want


def test_parse_nvidia_smi_rejects_unexpected_lines():
    with pytest.raises(ValueError):
        dv.parse_nvidia_smi("no comma here\n")


def test_query_without_tool_returns_empty(monkeypatch):
    monkeypatch.setattr(dv, "NVIDIA_SMI_QUERY", ["definitely-not-a-tool-xyz"])
    assert dv.query_nvidia_smi() == ("", [])


def test_device_stamp_names_platform(monkeypatch):
    monkeypatch.setattr(dv, "query_nvidia_smi", lambda: ("", []))
    stamp = dv.device_stamp()
    assert stamp["platform"] == "cpu" and stamp["device_count"] >= 1
    assert stamp["gpu_name"] is None and stamp["power_limit"] is None
