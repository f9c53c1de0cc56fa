"""One-dispatch all-views session tick over the shared device ring.

The reference renders every view off the same retained history ring each
frame (ref: Source/Spectrum/SpectrumRendering.cpp:620-635 re-reading
history per render frame; all views consume one presentation stream).
Round 4's :class:`~signalizer_tpu.session.AnalysisSession` dispatched
each view separately, so the production all-views tick paid one jit
dispatch + sync per view and missed the BASELINE <1 ms latency bar
(``local_session_p50_ms`` = 2.3). This module fuses spectrum +
oscilloscope + vectorscope into ONE jitted step whose inputs are
in-graph tail slices of the ring.

Parity contract: outputs and carried states are bit-equal to the
per-view path. Mechanism: the fused step calls the SAME impl functions
(``analyze_frames``, ``osc_step_impl``, ``vs_step_impl``) on the SAME
slices (``device_history._tail``), and the host-side bucket/scalar prep
is shared with the processors (``_prep_step``), so both paths dispatch
identical static keys and scalars. Locked by tests/test_fused_tick.py.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import numpy as np

from signalizer_tpu.kernels.spectrum import analyze_frames
from signalizer_tpu.stream.device_history import _tail
from signalizer_tpu.views.oscilloscope import osc_step_impl
from signalizer_tpu.views.vectorscope import vs_step_impl


@functools.partial(
    jax.jit,
    static_argnames=(
        "spec_w", "osc_n", "vs_w", "vs_mw", "trigger_chunk", "env_os",
        "mode", "autogain", "scale_to_fill",
    ),
    donate_argnames=("spec_state", "osc_state", "vs_state", "peak_env"),
)
def _fused_step(
    spec_const,
    osc_const,
    spec_state,
    osc_state,
    vs_state,
    peak_env,
    ring,
    osc_window,
    transport,
    osc_ns,
    vs_scalars,
    vs_ns,
    pair_keys,
    *,
    spec_w: int,
    osc_n: int,
    vs_w: int,
    vs_mw: int,
    trigger_chunk: Optional[int],
    env_os: Optional[int],
    mode,
    autogain,
    scale_to_fill: bool,
):
    spec_frames = _tail(ring, n=spec_w, lead=2, pad_to=2)
    r = analyze_frames(spec_const, spec_state, spec_frames)
    osc_frame, new_osc = osc_step_impl(
        osc_const, osc_state, _tail(ring, n=osc_n, lead=1),
        osc_window, transport, osc_ns, pair_keys,
        trigger_chunk=trigger_chunk, env_os=env_os,
    )
    vs_frame, new_vs, new_peak = vs_step_impl(
        vs_state, peak_env, _tail(ring, n=vs_w, lead=1),
        *vs_scalars, vs_ns, _tail(ring, n=vs_mw, lead=1),
        mode=mode, autogain=autogain, scale_to_fill=scale_to_fill,
    )
    return r.results[:, -1], r.state, osc_frame, new_osc, vs_frame, new_vs, new_peak


def run_fused_tick(session, dh, new_samples: int, transport: float):
    """Run one fused tick for ``session`` off device history ``dh``.

    Returns ``(spectrum [K, rows, P] np.ndarray, OscilloscopeFrame,
    VectorscopeFrame)`` with all three processors' states advanced, or
    ``None`` when the fused path is ineligible (a view missing, RSNT
    spectrum — it consumes the continuous stream, not the ring — or a
    window exceeding the ring) so the caller falls back to the per-view
    path for this tick.
    """
    from signalizer_tpu.views.spectrum import SpectrumProcessor

    sproc = session._processors.get("spectrum")
    oproc = session._processors.get("oscilloscope")
    vproc = session._processors.get("vectorscope")
    if sproc is None or oproc is None or vproc is None:
        return None
    if not isinstance(sproc, SpectrumProcessor):
        return None
    ring = dh.ring
    if ring is None or ring.shape[0] < 2:
        return None
    h = dh.history
    spec_w = sproc.constant.window_size
    osc_n = session._osc_history_len()
    vs_w = session._vs_window()
    if spec_w > h or osc_n > h or vs_w > h:
        return None
    osc_window, transport_dev, osc_ns, chunk, env_os, cycles_live = oproc._prep_step(
        osc_n, transport, min(int(new_samples), osc_n)
    )
    vs_mw = session._vs_meter_window(new_samples, vs_w)
    vs_scalars, vs_ns = vproc._prep_step(vs_w, new_samples, meter_w=vs_mw)
    res0, new_spec, osc_frame, new_osc, vs_frame, new_vs, new_peak = _fused_step(
        sproc.constant,
        oproc.constant,
        sproc._state,
        oproc._state,
        vproc._state,
        vproc._peak_env,
        ring,
        osc_window,
        transport_dev,
        osc_ns,
        vs_scalars,
        vs_ns,
        oproc._pair_keys,
        spec_w=spec_w,
        osc_n=osc_n,
        vs_w=vs_w,
        vs_mw=vs_mw,
        trigger_chunk=chunk,
        env_os=env_os,
        mode=vproc.mode,
        autogain=vproc.autogain,
        scale_to_fill=vproc.scale_to_fill,
    )
    sproc._state = new_spec
    oproc._state = new_osc
    vproc._state = new_vs
    vproc._peak_env = new_peak
    if cycles_live:
        oproc._post_cycle_feedback(osc_frame)
    return np.asarray(res0)[0], osc_frame, vs_frame
