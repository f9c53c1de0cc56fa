"""EditorShell — the interactive editor UI, served to a browser.

The reference's MainEditor is a tabbed single window hosting one active
view, per-view editor pages, global render settings, a preset widget and
the node-graph editor (ref: Source/Editor/MainEditor.{h,cpp} — tab bar
with auto-hide :68-69, UI pump timer :1387-1423, render settings
:393-400, serialization :1046-1080; GraphEditor.cpp drag-to-connect
:625). A JUCE window is GUI scope; this rebuild's interactive
shell is a browser app served by this stdlib HTTP server — the same
widget taxonomy (pages from :mod:`signalizer_tpu.views.controllers`,
resolved by :mod:`signalizer_tpu.editor.widgets`), the same tick loop
(:class:`signalizer_tpu.session.AnalysisSession`), the flat
host-parameter API for every knob edit, and the HostGraph model for the
graph editor — no dependencies beyond the standard library.

Threading: one tick thread drives ``session.feed`` (when a source is
attached) and ``session.tick`` at the engine's
``editor_settings.refresh_rate_ms`` cadence; HTTP handlers read the
latest cached frame under a lock and mutate parameters through the
engine's host API (thread-safe by the parameter system's design).
Parameter edits are classified by :func:`widgets.tier_of` — ``rebuild``
edits coalesce into one ``session.reconfigure(view)`` on the tick thread
(the reference's deferred ``handleFlagUpdates``), ``feed`` edits call
``session.refresh_feeds()``, ``render`` edits take effect on the next
frame via ``make_render_hints()``.
"""

from __future__ import annotations

import base64
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

import numpy as np

from signalizer_tpu.editor import widgets as widget_models
from signalizer_tpu.session import ALL_VIEWS, AnalysisSession
from signalizer_tpu.stream.audio_stream import Playhead
from signalizer_tpu.stream.host_graph import HostGraph, PortPair
from signalizer_tpu.utils.exception_log import log_exception
from signalizer_tpu.utils.png import encode_png

__all__ = ["EditorShell"]

VIEW_CONTENT = {
    "spectrum": "spectrum",
    "spectrogram": "spectrum",  # shares SpectrumContent (DisplayMode)
    "oscilloscope": "oscilloscope",
    "vectorscope": "vectorscope",
}

# graph-tab + settings-tab follow the four views (reference tab order is
# the view registration order, MainEditor.cpp:70-75)
TABS = list(ALL_VIEWS) + ["graph", "global"]


def _np_list(a, decimals=5):
    return np.round(np.asarray(a, np.float64), decimals).tolist()


class EditorShell:
    """Serve an interactive editor for one :class:`AnalysisSession`."""

    def __init__(
        self,
        session: AnalysisSession,
        *,
        source: Optional[Callable[[int], np.ndarray]] = None,
        playhead: Optional[Playhead] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        block_size: int = 1024,
    ):
        self.session = session
        self.engine = session.engine
        self.source = source
        self.playhead = playhead
        self.block_size = block_size
        self._lock = threading.Lock()
        self._frame = None
        self._tick_count = 0
        self._pending_rebuild: set = set()
        self._pending_feeds = False
        self._running = False
        self._thread: Optional[threading.Thread] = None
        shell = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _bytes(self, body: bytes, ctype: str):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    shell._get(self)
                except BrokenPipeError:
                    pass
                except Exception as e:  # surface handler faults to the client
                    try:
                        self._json({"error": repr(e)}, 500)
                    except Exception:
                        pass

            def do_POST(self):
                try:
                    # CSRF defense for the fixed local port: browsers can
                    # fire no-preflight text/plain POSTs at localhost from
                    # any webpage, so (a) mutating endpoints require an
                    # explicit application/json Content-Type (cross-origin
                    # JSON POSTs trigger a preflight we never answer), and
                    # (b) a present Origin header must match this server.
                    ctype = (
                        (self.headers.get("Content-Type") or "")
                        .split(";")[0]
                        .strip()
                        .lower()
                    )
                    if ctype != "application/json":
                        self._json(
                            {"error": "Content-Type must be application/json"}, 415
                        )
                        return
                    if not shell._origin_allowed(self.headers):
                        self._json({"error": "forbidden origin"}, 403)
                        return
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    shell._post(self, body)
                except BrokenPipeError:
                    pass
                except Exception as e:
                    try:
                        self._json({"error": repr(e)}, 500)
                    except Exception:
                        pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True

    # ------------------------------------------------------------------ http
    @property
    def url(self) -> str:
        h, p = self._server.server_address[:2]
        return f"http://{h}:{p}/"

    def _origin_allowed(self, headers) -> bool:
        """A present Origin header must name this server (the app itself
        is same-origin; anything else is a cross-site request). Absent
        Origin (CLI tools, same-origin fetches in some browsers) passes —
        the Content-Type gate in do_POST already blocks no-preflight
        browser POSTs."""
        origin = headers.get("Origin")
        if origin is None:
            return True
        if origin == "null":
            return False
        from urllib.parse import urlsplit

        try:
            parts = urlsplit(origin)
        except ValueError:
            return False
        if parts.scheme not in ("http", "https"):
            return False
        host, port = self._server.server_address[:2]
        allowed_hosts = {host, "localhost", "127.0.0.1", "[::1]", "::1"}
        origin_port = parts.port if parts.port is not None else (
            443 if parts.scheme == "https" else 80
        )
        return parts.hostname in allowed_hosts and origin_port == port

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._tick_loop, daemon=True)
        self._thread.start()
        self._http = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._http.start()

    def stop(self) -> None:
        self._running = False
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # ------------------------------------------------------------------ loop
    def _tick_loop(self) -> None:
        while self._running:
            t0 = time.perf_counter()
            try:
                self._apply_pending()
                if self.source is not None and not self.session.freeze:
                    # audio cadence: enough blocks to cover one UI tick
                    interval = self.engine.editor_settings.refresh_rate_ms / 1000.0
                    n_blocks = max(
                        1,
                        int(
                            interval
                            * self.engine.config.sample_rate
                            / self.block_size
                        ),
                    )
                    for _ in range(n_blocks):
                        self.session.feed(
                            self.source(self.block_size), self.playhead
                        )
                        # advance the playhead with the audio: a frozen
                        # steady_clock makes the mix graph treat every
                        # later block as a full overlap and DROP it — the
                        # presentation stream stuck at the first block
                        # (round-3 review, reproduced empirically)
                        if self.playhead is not None:
                            self.playhead = self.playhead.advanced(
                                self.block_size
                            )
                frame = self.session.tick()
                with self._lock:
                    self._frame = frame
                    self._tick_count += 1
            except Exception as exc:
                # keep the loop alive, but never silently: reconfigure /
                # feed failures here happen AFTER the pending-edit sets
                # were consumed (ref: the cpl exception log absorbs
                # editor-loop faults the same way, MainEditor.cpp:176)
                log_exception("editor tick loop", exc)
            dt = time.perf_counter() - t0
            interval = self.engine.editor_settings.refresh_rate_ms / 1000.0
            time.sleep(max(0.0, interval - dt))

    def _apply_pending(self) -> None:
        with self._lock:
            rebuild, self._pending_rebuild = self._pending_rebuild, set()
            feeds, self._pending_feeds = self._pending_feeds, False
        for view in rebuild:
            if view in self.session.views:
                self.session.reconfigure(only=view)
        # a spectrum rebuild already rebuilt the feeds; any OTHER pending
        # rebuild must not swallow a queued feed edit
        if feeds and "spectrum" not in rebuild:
            self.session.refresh_feeds()

    # ------------------------------------------------------------------ GET
    def _get(self, h) -> None:
        path = h.path.split("?")[0]
        if path == "/":
            from signalizer_tpu.editor.static import INDEX_HTML

            self._bytes_of(h, INDEX_HTML.encode(), "text/html; charset=utf-8")
        elif path == "/api/state":
            h._json(self._state())
        elif path.startswith("/api/layout/"):
            view = path.rsplit("/", 1)[1]
            content = getattr(self.engine, VIEW_CONTENT[view])
            h._json(
                {
                    "view": view,
                    "set": content.NAME,
                    "pages": widget_models.describe_pages(content),
                }
            )
        elif path.startswith("/api/frame/"):
            view = path.rsplit("/", 1)[1]
            h._json(self._frame_payload(view))
        elif path == "/api/spectrogram.png":
            sg = self.session.processor("spectrogram")
            if sg is None:
                h._json({"error": "no spectrogram"}, 404)
                return
            img = np.asarray(sg.image.snapshot())  # [time, freq, 4]
            # freq on y (low at bottom), time on x
            self._bytes_of(
                h, encode_png(np.transpose(img, (1, 0, 2))[::-1]), "image/png"
            )
        elif path == "/api/graph":
            h._json(self._graph_model())
        elif path == "/api/presets":
            h._json({"presets": self.engine.presets.list_presets()})
        elif path == "/api/exceptions":
            # reveal the exception log from the global settings, by the
            # presets (ref: CHANGELOG 0.4.2 "Button in the global settings
            # by the presets to reveal the exception log";
            # MainEditor.cpp:176 CheckPruneExceptionLogFile)
            from signalizer_tpu.utils.exception_log import get_exception_log_path

            log_path = get_exception_log_path()
            try:
                data = log_path.read_bytes() if log_path.exists() else b""
            except OSError:
                data = b""
            tail = data[-8192:].decode("utf-8", errors="replace")
            h._json(
                {
                    "path": str(log_path),
                    "size_bytes": len(data),
                    "tail": tail,
                }
            )
        else:
            h._json({"error": "not found"}, 404)

    @staticmethod
    def _bytes_of(h, body: bytes, ctype: str) -> None:
        h._bytes(body, ctype)

    def _state(self) -> Dict:
        es = self.engine.editor_settings
        with self._lock:
            ticks = self._tick_count
            frame = self._frame
        diag = dict(frame.diagnostics) if frame is not None else {}
        return {
            "tabs": TABS,
            "selected_tab": es.selected_tab,
            "freeze": self.session.freeze,
            "refresh_rate_ms": es.refresh_rate_ms,
            "hide_tabs": es.hide_tabs,
            "hide_widgets_on_mouse_exit": es.hide_widgets_on_mouse_exit,
            "kiosk": es.kiosk,
            "legend_choice": es.legend_choice,
            "antialias_level": es.antialias_level,
            "vsync": es.vsync,
            "colour_scheme": {k: list(v) for k, v in es.colour_scheme.items()},
            "ticks": ticks,
            "engine": self.engine.host_graph.name,
            "graph_serialization": int(self.engine.host_graph.serialization_control),
            "diagnostics": {k: round(float(v), 3) for k, v in diag.items()},
            "perf": {
                k: round(float(v), 4) for k, v in self.engine.perf_snapshot().items()
            },
        }

    def _frame_payload(self, view: str) -> Dict:
        with self._lock:
            frame = self._frame
            ticks = self._tick_count
        if frame is None:
            return {"ready": False}
        out: Dict = {"ready": True, "tick": ticks}
        if view == "spectrum" and frame.line_graph is not None:
            lg = frame.line_graph
            out["background"] = _np_list(lg.background_colour)
            out["grid_colour"] = _np_list(lg.grid_colour)
            out["primitive_size"] = float(lg.primitive_size)
            out["grid"] = [
                {"p": round(float(l.position), 5), "label": str(l.label)}
                for l in lg.grid
            ]
            out["db_grid"] = [
                {"p": round(float(l.position), 5), "label": str(l.label)}
                for l in lg.db_grid
            ]
            out["strips"] = [
                {
                    "y": _np_list(s.vertices[:, 1], 4),
                    "colour": _np_list(s.colour),
                    "label": str(s.label),
                }
                for s in lg.strips
            ]
            out["floods"] = [
                {
                    "top": _np_list(f.vertices[0::2, 1], 4),
                    "end": _np_list(f.vertices[1::2, 1], 4),
                    "colour": _np_list(f.colour),
                }
                for f in lg.floods
            ]
            if frame.tracker:
                out["tracker"] = {
                    k: (round(float(v), 3) if isinstance(v, (int, float)) else v)
                    for k, v in frame.tracker.items()
                }
        elif view == "spectrum" and frame.spectrum is not None:
            out["rows"] = _np_list(
                np.asarray(frame.spectrum).reshape(-1, frame.spectrum.shape[-1]), 4
            )
        elif view == "oscilloscope" and frame.oscilloscope is not None:
            f = frame.oscilloscope
            wave = np.asarray(f.waveform)
            cols = np.clip(np.asarray(f.colours) * 255.0, 0, 255).astype(np.uint8)
            out["waveform"] = _np_list(wave, 4)
            out["env_min"] = _np_list(np.asarray(f.envelope_min), 4)
            out["env_max"] = _np_list(np.asarray(f.envelope_max), 4)
            out["colours_u8"] = base64.b64encode(cols.tobytes()).decode()
            out["shape"] = list(wave.shape)
            out["gain"] = _np_list(f.gain, 4)
            out["fundamental"] = _np_list(f.fundamental, 2)
            out["trigger_found"] = np.asarray(f.trigger_found).astype(bool).tolist()
            out["hints"] = self._hints("oscilloscope")
        elif view == "vectorscope" and frame.vectorscope is not None:
            f = frame.vectorscope
            v = np.asarray(f.vertices)
            if v.shape[-2] > 2048:  # decimate the point cloud for the wire
                v = v[..., :: int(np.ceil(v.shape[-2] / 2048)), :]
            out["vertices"] = _np_list(v, 4)
            out["balance"] = _np_list(f.balance, 4)
            out["correlation"] = _np_list(f.correlation_bars, 4)
            out["gain"] = _np_list(f.gain, 4)
            out["hints"] = self._hints("vectorscope")
        elif view == "spectrogram":
            sg = self.session.processor("spectrogram")
            if sg is not None:
                out["image_tick"] = ticks  # client refetches /api/spectrogram.png
                out["height"] = int(sg.image.height)
                out["width"] = int(sg.image.display_width)
        return out

    def _hints(self, view: str) -> Dict:
        content = getattr(self.engine, VIEW_CONTENT[view])
        hints = content.make_render_hints()
        out = {}
        for k, v in hints.items():
            if isinstance(v, (int, float, bool, str)):
                out[k] = v
            elif isinstance(v, (tuple, list, np.ndarray)):
                try:
                    out[k] = _np_list(v)
                except (TypeError, ValueError):
                    pass
        return out

    def _graph_model(self) -> Dict:
        model = self.engine.host_graph.get_model()
        return {
            "self": self.engine.host_graph.node_id.hex(),
            "nodes": model.nodes,
            "edges": [
                {"src": s, "dst": d, "src_ch": p.source, "dst_ch": p.destination}
                for s, d, p in model.edges
            ],
            "missing": model.missing,
        }

    # ------------------------------------------------------------------ POST
    def _post(self, h, body: Dict) -> None:
        path = h.path.split("?")[0]
        if path == "/api/param":
            h._json(self._set_param(body))
        elif path == "/api/settings":
            h._json(self._set_settings(body))
        elif path == "/api/freeze":
            self.session.freeze = bool(body.get("freeze", not self.session.freeze))
            h._json({"freeze": self.session.freeze})
        elif path == "/api/cursor":
            frac = body.get("fraction")
            had = self.session.cursor_fraction is not None
            self.session.cursor_fraction = None if frac is None else float(frac)
            # the tracker feed exists iff a cursor does — (re)build it on
            # the tick thread when that changes (a session built without
            # a cursor otherwise never grows a tracker, and clearing the
            # cursor left a stale tracker raising every tick)
            if had != (frac is not None):
                with self._lock:
                    self._pending_feeds = True
            h._json({"ok": True})
        elif path == "/api/graph/connect":
            src = bytes.fromhex(body["src"])
            pair = PortPair(int(body.get("src_ch", 0)), int(body.get("dst_ch", 0)))
            ok = (
                self.engine.host_graph.disconnect(src, pair)
                if body.get("disconnect")
                else self.engine.host_graph.connect(src, pair)
            )
            h._json({"ok": bool(ok), **self._graph_model()})
        elif path == "/api/graph/toggle":
            ok = self.engine.host_graph.toggle_set(bytes.fromhex(body["src"]))
            h._json({"ok": bool(ok), **self._graph_model()})
        elif path == "/api/graph/rename":
            self.engine.host_graph.name = str(body.get("name", ""))[:64] or (
                self.engine.host_graph.name
            )
            h._json({"ok": True, **self._graph_model()})
        elif path == "/api/graph/identity":
            ok = self.engine.host_graph.assume_identity_of(bytes.fromhex(body["id"]))
            h._json({"ok": bool(ok), **self._graph_model()})
        elif path == "/api/presets/load":
            ok = self.engine.load_preset(str(body["name"]))
            if ok:  # preset changed every content: rebuild everything
                with self._lock:
                    self._pending_rebuild.update(self.session.views)
            h._json({"ok": bool(ok)})
        elif path == "/api/presets/save":
            try:
                self.engine.save_preset(str(body["name"]))
            except ValueError as e:  # invalid preset name — handled, not a fault
                h._json({"error": str(e)})
            else:
                h._json({"ok": True, "presets": self.engine.presets.list_presets()})
        else:
            h._json({"error": "not found"}, 404)

    def _set_param(self, body: Dict) -> Dict:
        set_name = body["set"]
        name = body["name"]
        ps = self.engine.parameter_map.get_set(set_name)
        if ps is None:
            return {"error": f"no parameter set {set_name}"}
        p = ps.find(name)
        if p is None:
            return {"error": f"no parameter {set_name}.{name}"}
        # edits are UI-sourced (update_from_ui_normalized), wrapped in host
        # gestures — exactly a knob drag in the reference's editor, which
        # transmits the change to the automation host
        # (PluginProcessor.cpp:414-438; setValueNormalized -> transmit)
        idx = self.engine.parameter_map.flat_index_of(p)
        if "text" in body:
            if not p.set_from_text(str(body["text"])):
                return {
                    "error": "unparseable",
                    "display": p.get_display_text(),
                    "normalized": p.get_normalized(),
                }
        else:
            gesture = bool(body.get("gesture", True))
            if gesture:
                self.engine.begin_parameter_gesture(idx)
            p.update_from_ui_normalized(float(body["normalized"]))
            if gesture:
                self.engine.end_parameter_gesture(idx)
        tier = widget_models.tier_of(set_name, name)
        if tier == "rebuild":
            with self._lock:
                for view, content_attr in VIEW_CONTENT.items():
                    if getattr(self.engine, content_attr).NAME == set_name:
                        self._pending_rebuild.add(view)
        elif tier == "feed":
            with self._lock:
                self._pending_feeds = True
        self.engine.pulse_ui()
        return {
            "display": p.get_display_text(),
            "normalized": p.get_normalized(),
            "tier": tier,
        }

    def _set_settings(self, body: Dict) -> Dict:
        es = self.engine.editor_settings
        if "refresh_rate_ms" in body:
            es.refresh_rate_ms = float(
                min(1000.0, max(10.0, body["refresh_rate_ms"]))
            )
        if "selected_tab" in body:
            es.selected_tab = int(body["selected_tab"])
        if "hide_tabs" in body:
            es.hide_tabs = bool(body["hide_tabs"])
        if "hide_widgets_on_mouse_exit" in body:
            es.hide_widgets_on_mouse_exit = bool(body["hide_widgets_on_mouse_exit"])
        if "kiosk" in body:
            es.kiosk = bool(body["kiosk"])
        if "legend_choice" in body:
            es.legend_choice = int(body["legend_choice"])
        if "vsync" in body:
            es.vsync = bool(body["vsync"])
        if "antialias_level" in body:
            es.antialias_level = int(body["antialias_level"])
        if "colour" in body:
            name, rgba = body["colour"]["name"], body["colour"]["rgba"]
            if name in es.colour_scheme and len(rgba) == 4:
                es.colour_scheme[name] = tuple(float(x) for x in rgba)
        if "graph_serialization" in body:
            # how the sidechain graph rides custom presets (ref:
            # CHANGELOG 0.4.2 drop-down by the presets; HostGraph.h:194-263)
            from signalizer_tpu.stream.host_graph import SerializationControl

            self.engine.host_graph.serialization_control = SerializationControl(
                int(body["graph_serialization"])
            )
        return self._state()
