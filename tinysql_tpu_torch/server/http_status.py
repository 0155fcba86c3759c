"""Status HTTP endpoint (reference: server/http_status.go:32-99 — index
page, /status JSON, pprof routes; pprof is Go-specific, the analogue here
is /debug/threads) plus the observability surfaces: Prometheus-text
``/metrics`` (obs/metrics.py), ``/debug/trace`` (the last N query traces
as JSON, chrome://tracing-loadable per entry), and ``/debug/slowlog``
(recent structured slow-query records).
"""
from __future__ import annotations

import json
import sys
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse


#: (path, one-line description) for every registered debug endpoint —
#: the GET /debug/ index renders this list (otherwise the surfaces are
#: discoverable only by reading docs)
DEBUG_ENDPOINTS = (
    ("/debug/trace", "last N query traces (JSON; chrome://tracing "
                     "loadable per entry; ?n=)"),
    ("/debug/slowlog", "recent structured slow-query records (JSON)"),
    ("/debug/stmtsummary", "statement summary current window (JSON; "
                           "?incarnation=N replays a prior run)"),
    ("/debug/metrics/summary", "windowed per-metric delta/rate/avg/max "
                               "(JSON)"),
    ("/debug/inspection", "automated inspection findings (JSON; "
                          "?window=, ?incarnation=N)"),
    ("/debug/programs", "compiled-program catalog (JSON)"),
    ("/debug/conprof", "continuous profiler collapsed stacks "
                       "(flamegraph text; ?window=, ?incarnation=N)"),
    ("/debug/heap", "heap profiler collapsed allocation sites "
                    "(flamegraph text; ?window=)"),
    ("/debug/prewarm", "auto-prewarm worker snapshot (JSON)"),
    ("/debug/flight", "flight recorder: arming, stats, incarnation "
                      "catalogue (JSON)"),
    ("/debug/threads", "live python stacks, all threads (text)"),
)


def _prior_incarnation(qs) -> Optional[int]:
    """``?incarnation=N`` → N when N names a PRIOR run; None means
    serve the live surface (absent, junk, or the current id)."""
    from ..obs.flight import current_incarnation
    try:
        n = int(qs.get("incarnation", [""])[0])
    except (ValueError, IndexError):
        return None
    return n if 0 < n < current_incarnation() else None


def _make_handler(server_ref):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send_prior(self, tier: str, incarnation: int,
                        columns) -> None:
            # a prior incarnation's replayed mem-table rows (the live
            # endpoint's dict/text shape only exists for the live
            # stores; dead runs serve rows + column names)
            from ..obs.flight import active_store
            store = active_store()
            rows = store.tier_rows(incarnation, tier) \
                if store is not None else []
            self._send(200, json.dumps(
                {"incarnation": incarnation,
                 "columns": [c[0] for c in columns],
                 "rows": rows}, default=str).encode())

        def _send(self, code: int, body: bytes,
                  ctype: str = "application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            srv = server_ref()
            parsed = urlparse(self.path)
            if parsed.path == "/metrics":
                from ..obs.metrics import render_prometheus
                self._send(200, render_prometheus().encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
                return
            if parsed.path == "/debug/trace":
                from ..obs.trace import recent_traces
                qs = parse_qs(parsed.query)
                try:
                    n = int(qs.get("n", ["0"])[0])
                except ValueError:
                    n = 0
                n = n if n > 0 else None  # last-N only; junk = everything
                self._send(200, json.dumps(
                    recent_traces(n), default=str).encode())
                return
            if parsed.path == "/debug/slowlog":
                from ..obs.slowlog import recent
                self._send(200, json.dumps(recent(), default=str).encode())
                return
            if parsed.path == "/debug/stmtsummary":
                from ..obs.stmtsummary import COLUMNS, snapshot
                qs = parse_qs(parsed.query)
                prior = _prior_incarnation(qs)
                if prior is not None:
                    self._send_prior("summary", prior, COLUMNS)
                    return
                self._send(200, json.dumps(snapshot(),
                                           default=str).encode())
                return
            if parsed.path == "/debug/inspection":
                from ..obs import inspect as oinspect
                qs = parse_qs(parsed.query)
                prior = _prior_incarnation(qs)
                if prior is not None:
                    self._send_prior("findings", prior, oinspect.COLUMNS)
                    return
                # absent -> the bounded default window; window=0 -> the
                # whole retained ring
                try:
                    window = float(
                        qs.get("window", [oinspect.DEFAULT_WINDOW_S])[0]
                    ) or None
                except ValueError:
                    window = oinspect.DEFAULT_WINDOW_S
                self._send(200, json.dumps(
                    oinspect.snapshot(window_s=window),
                    default=str).encode())
                return
            if parsed.path == "/debug/metrics/summary":
                from ..obs.tsring import RING
                self._send(200, json.dumps(
                    RING.summary_rows(), default=str).encode())
                return
            if parsed.path == "/debug/conprof":
                # collapsed-stack text (flamegraph.pl / speedscope
                # ingest it directly); ?window=N bounds to the last N
                # seconds of retained windows (absent/0 = everything)
                from ..obs.conprof import COLUMNS, collapsed
                qs = parse_qs(parsed.query)
                prior = _prior_incarnation(qs)
                if prior is not None:
                    self._send_prior("conprof", prior, COLUMNS)
                    return
                try:
                    window = float(qs.get("window", ["0"])[0]) or None
                except ValueError:
                    window = None
                self._send(200, collapsed(window_s=window).encode(),
                           "text/plain; charset=utf-8")
                return
            if parsed.path == "/debug/heap":
                # collapsed allocation-site text (same format as
                # /debug/conprof — conprof.parse_collapsed and
                # flamegraph.pl ingest both; counts are live KB);
                # ?window=N bounds to the last N seconds of windows
                from ..obs.memprof import collapsed as heap_collapsed
                qs = parse_qs(parsed.query)
                try:
                    window = float(qs.get("window", ["0"])[0]) or None
                except ValueError:
                    window = None
                self._send(200,
                           heap_collapsed(window_s=window).encode(),
                           "text/plain; charset=utf-8")
                return
            if parsed.path == "/debug/programs":
                from ..ops.progcache import catalog_snapshot
                self._send(200, json.dumps(catalog_snapshot(),
                                           default=str).encode())
                return
            if parsed.path == "/debug/flight":
                from ..obs.flight import debug_snapshot
                self._send(200, json.dumps(debug_snapshot(),
                                           default=str).encode())
                return
            if parsed.path in ("/debug", "/debug/"):
                rows = "".join(
                    f'<li><a href="{p}">{p}</a> — {desc}</li>'
                    for p, desc in DEBUG_ENDPOINTS)
                self._send(200, ("<h1>debug endpoints</h1><ul>"
                                 f"{rows}</ul>").encode(), "text/html")
                return
            if parsed.path == "/debug/prewarm":
                from ..session.prewarm import stats_snapshot
                worker = getattr(srv, "prewarm", None) if srv else None
                body = worker.snapshot() if worker is not None \
                    else {"stats": stats_snapshot()}
                self._send(200, json.dumps(body, default=str).encode())
                return
            if parsed.path == "/status":
                from ..server.protocol import SERVER_VERSION
                from ..server.admission import stats_snapshot as adm
                from ..ops.batching import stats_snapshot as batch
                pool = getattr(srv, "pool", None) if srv else None
                body = json.dumps({
                    "version": SERVER_VERSION,
                    "connections": len(srv.conns) if srv else 0,
                    "tls_connections": sum(
                        1 for c in list(srv.conns.values())
                        if getattr(c, "tls", False)) if srv else 0,
                    "pool": pool.snapshot() if pool is not None else {},
                    "admission": adm(),
                    "batching": batch(),
                }).encode()
                self._send(200, body)
            elif parsed.path == "/debug/threads":
                out = []
                for tid, frame in sys._current_frames().items():
                    out.append(f"--- thread {tid} ---")
                    out.extend(traceback.format_stack(frame))
                self._send(200, "\n".join(out).encode(),
                           "text/plain; charset=utf-8")
            elif parsed.path == "/":
                self._send(200, b"<h1>tinysql-tpu status</h1>"
                           b'<a href="/status">status</a> '
                           b'<a href="/metrics">metrics</a> '
                           b'<a href="/debug/trace">traces</a> '
                           b'<a href="/debug/slowlog">slowlog</a> '
                           b'<a href="/debug/stmtsummary">stmtsummary</a> '
                           b'<a href="/debug/programs">programs</a> '
                           b'<a href="/debug/conprof">conprof</a> '
                           b'<a href="/debug/heap">heap</a> '
                           b'<a href="/debug/prewarm">prewarm</a> '
                           b'<a href="/debug/inspection">inspection</a> '
                           b'<a href="/debug/metrics/summary">'
                           b'metrics-summary</a> '
                           b'<a href="/debug/flight">flight</a> '
                           b'<a href="/debug/">debug-index</a> '
                           b'<a href="/debug/threads">threads</a>',
                           "text/html")
            else:
                self._send(404, b"{}")
    return Handler


class StatusServer:
    def __init__(self, mysql_server, host: str = "127.0.0.1", port: int = 0):
        import weakref
        ref = weakref.ref(mysql_server) if mysql_server is not None \
            else (lambda: None)
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(ref))
        self.port = self.httpd.server_address[1]

    def start(self) -> int:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                             name="status-http")
        t.start()
        return self.port

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
