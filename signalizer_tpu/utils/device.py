"""Process-level device facts: the compile cache location and the card.

Shared by ``python -m signalizer_tpu``, ``bench.py``, ``chip_smoke.py``
and the profiling tools, so every entry point keeps its compiled code in
the same place and stamps its records with the same device description.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import List, Mapping, Optional, Tuple

# the checkout root (the directory that holds the ``signalizer_tpu`` package)
CHECKOUT_ROOT = Path(__file__).resolve().parents[2]

NVIDIA_SMI_QUERY = [
    "nvidia-smi",
    "--query-gpu=name,power.limit",
    "--format=csv,noheader",
]


def compile_cache_dir(environ: Optional[Mapping[str, str]] = None) -> Tuple[str, bool]:
    """Where JAX's persistent compile cache lives, and whether the
    environment chose it.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins. Otherwise the fixed
    path ``<checkout>/.jax_cache``: a path that changed between runs
    (temporary, per-process, time-stamped) would never hit."""
    env = os.environ if environ is None else environ
    chosen = env.get("JAX_COMPILATION_CACHE_DIR")
    if chosen:
        return chosen, True
    return str(CHECKOUT_ROOT / ".jax_cache"), False


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`.

    When the environment names the directory, JAX reads it itself and
    nothing is set here. Returns the directory in use."""
    path, from_env = compile_cache_dir()
    if not from_env:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path


def parse_nvidia_smi(text: str) -> List[dict]:
    """Parse ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` output: one ``{"name", "power_limit",
    "power_limit_w"}`` per card (``power_limit_w`` is None when the card
    reports no number, e.g. ``[N/A]``)."""
    cards = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        name, sep, limit = line.rpartition(",")
        if not sep:
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        limit = limit.strip()
        try:
            watts = float(limit.split()[0])
        except (IndexError, ValueError):
            watts = None
        cards.append({"name": name.strip(), "power_limit": limit, "power_limit_w": watts})
    return cards


def query_nvidia_smi() -> Tuple[str, List[dict]]:
    """Run the ``nvidia-smi`` query; ``("", [])`` when there is no tool."""
    try:
        proc = subprocess.run(
            NVIDIA_SMI_QUERY, capture_output=True, text=True, timeout=60, check=True
        )
    except (OSError, subprocess.SubprocessError):
        return "", []
    return proc.stdout.strip(), parse_nvidia_smi(proc.stdout)


def device_stamp() -> dict:
    """What JAX runs on, and the card's name and power limit: the fields
    every measured record carries."""
    import jax

    devices = jax.devices()
    _, cards = query_nvidia_smi()
    return {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "gpu_name": cards[0]["name"] if cards else None,
        "power_limit": cards[0]["power_limit"] if cards else None,
    }
