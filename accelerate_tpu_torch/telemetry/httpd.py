"""A stdlib threaded HTTP endpoint for ``/metrics``, ``/healthz`` and
``/traces``, and the multi-process fleet's inference front door.

A copy of :mod:`accelerate_tpu.telemetry.httpd` (stdlib only), kept here
so the port imports nothing of the JAX package; status codes, JSON
bodies, SSE event sequences and ``/metrics`` bytes are the reference's.
``ThreadingHTTPServer`` from the stdlib, one daemon accept thread,
handlers that *read* injected callables and format outside any lock.

* ``GET /metrics``  -- the wired ``metrics_fn``'s text verbatim
  (``text/plain; version=0.0.4``): ``FleetRouter.prometheus_text`` behind
  :meth:`TelemetryHTTPD.for_router`, the supervisor's ``proc_*`` lines
  behind :meth:`TelemetryHTTPD.for_supervisor`;
* ``GET /healthz``  -- the health rows as JSON; 200 while any replica
  still serves, 503 once none does. Behind
  :meth:`TelemetryHTTPD.for_supervisor` the rows are worker processes
  (``ProcessSupervisor.health()``), so 503 means zero live workers;
* ``GET /traces``   -- recent completed traces (``?n=`` caps the count).

With a request surface attached (:meth:`TelemetryHTTPD.for_supervisor`),
the front door also serves inference:

* ``POST /v1/generate``        -- body ``{"prompt": [ids], "max_new_tokens",
  "stop_sequences", "priority", "stream"}``; the ``X-Priority`` header (an
  integer scheduler class, lower admits sooner) or the ``X-SLO-Class``
  alias (``interactive``/``standard``/``batch``) overrides the body
  priority. Non-streaming replies one JSON document when the request
  finishes; ``"stream": true`` (or ``Accept: text/event-stream``)
  switches to SSE: one ``event: token`` per new token (``data`` is
  ``{"i", "token", "lp"}``), then a terminal ``event: done`` /
  ``event: error``. A client disconnect mid-stream cancels the request.
  429 when the fleet sheds, 503 when zero workers serve.
* ``GET /v1/requests/<id>``    -- request state snapshot (JSON);
* ``DELETE /v1/generate/<id>`` -- cancel; replies the tokens so far.

Host concurrency: the accept loop runs in a module-level function that
receives the server object as an argument, so no shared mutable
attribute crosses threads; ``stop()`` shuts the server down and joins the
(daemon) thread from the caller's context with no lock held.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

#: health states that count as "still serving" for the 503 decision —
#: mirrors ``Replica.is_serving`` in serving_fleet.py (and
#: ``SERVING_WORKER_STATES`` in serving_proc.py for worker processes).
_SERVING_STATES = ("healthy", "degraded")

#: ``X-SLO-Class`` header -> integer scheduler class (lower admits sooner)
SLO_CLASSES = {"interactive": 0, "standard": 1, "batch": 2}

#: terminal request states (the stream/poll loop stops on these)
_TERMINAL_STATES = ("done", "cancelled", "lost", "shed")


def _serve(srv: ThreadingHTTPServer) -> None:
    """Accept-loop thread body. Takes the server as an argument so the
    thread shares no mutable attribute with the owning object."""
    srv.serve_forever(poll_interval=0.05)


class _Handler(BaseHTTPRequestHandler):
    """Routes the three endpoints; all state comes from ``server.app``,
    a dict of callables frozen before the accept thread starts."""

    server_version = "accelerate-tpu-telemetry/1"

    def do_GET(self):  # noqa: N802 - stdlib handler contract
        app = self.server.app
        parsed = urlparse(self.path)
        route = parsed.path.rstrip("/") or "/"
        if route == "/metrics":
            body = app["metrics"]().encode("utf-8")
            self._reply(200, body, "text/plain; version=0.0.4; charset=utf-8")
        elif route == "/healthz":
            health = app["health"]()
            serving = any(row.get("health") in _SERVING_STATES for row in health.values())
            body = json.dumps({"serving": serving, "replicas": health}, sort_keys=True).encode("utf-8")
            self._reply(200 if serving else 503, body, "application/json")
        elif route == "/traces":
            qs = parse_qs(parsed.query)
            try:
                n = int(qs.get("n", ["64"])[0])
            except ValueError:
                n = 64
            body = json.dumps({"traces": app["traces"](max(0, n))}, default=repr).encode("utf-8")
            self._reply(200, body, "application/json")
        elif route.startswith("/v1/requests/") and app.get("stream") is not None:
            rid = self._request_id(route)
            if rid is None:
                self._reply(400, b'{"error": "bad request id"}\n', "application/json")
                return
            try:
                state = app["stream"](rid)
            except KeyError:
                self._reply(404, b'{"error": "unknown request"}\n', "application/json")
                return
            body = json.dumps({"id": rid, **state}, sort_keys=True).encode("utf-8")
            self._reply(200, body, "application/json")
        else:
            self._reply(404, b'{"error": "unknown path"}\n', "application/json")

    # ------------------------------------------------------------------ #
    # inference front door (only routed when a submit surface is wired)
    # ------------------------------------------------------------------ #

    def do_POST(self):  # noqa: N802 - stdlib handler contract
        app = self.server.app
        route = urlparse(self.path).path.rstrip("/")
        if route != "/v1/generate" or app.get("submit") is None:
            self._reply(404, b'{"error": "unknown path"}\n', "application/json")
            return
        try:
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n).decode("utf-8") or "{}")
            prompt = [int(t) for t in body["prompt"]]
        except (KeyError, TypeError, ValueError, UnicodeDecodeError, json.JSONDecodeError):
            self._reply(
                400,
                b'{"error": "body must be JSON with an integer \\"prompt\\" list"}\n',
                "application/json",
            )
            return
        stream = bool(body.get("stream")) or "text/event-stream" in (
            self.headers.get("Accept") or ""
        )
        try:
            rid = app["submit"](
                {
                    "prompt": prompt,
                    "max_new_tokens": int(body.get("max_new_tokens", 16)),
                    "stop_sequences": body.get("stop_sequences") or [],
                    "priority": self._priority(body),
                }
            )
        except Exception as e:  # noqa: BLE001 - mapped to a structured status
            msg = str(e)
            status = 429 if ("shed" in msg or "draining" in msg) else 503
            self._reply(
                status, json.dumps({"error": msg}).encode("utf-8"), "application/json"
            )
            return
        if stream:
            self._stream_sse(app, rid)
        else:
            self._wait_json(app, rid, timeout=float(body.get("timeout_s", 120.0)))

    def do_DELETE(self):  # noqa: N802 - stdlib handler contract
        app = self.server.app
        route = urlparse(self.path).path.rstrip("/")
        if not route.startswith("/v1/generate/") or app.get("cancel") is None:
            self._reply(404, b'{"error": "unknown path"}\n', "application/json")
            return
        rid = self._request_id(route)
        if rid is None:
            self._reply(400, b'{"error": "bad request id"}\n', "application/json")
            return
        try:
            tokens = app["cancel"](rid)
        except KeyError:
            self._reply(404, b'{"error": "unknown request"}\n', "application/json")
            return
        body = json.dumps({"id": rid, "cancelled": True, "tokens": list(tokens)})
        self._reply(200, body.encode("utf-8"), "application/json")

    def _priority(self, body: dict) -> int:
        """Body priority, overridden by the ``X-SLO-Class`` name or an
        explicit integer ``X-Priority`` header (which wins)."""
        priority = int(body.get("priority", 0))
        slo = self.headers.get("X-SLO-Class")
        if slo:
            priority = SLO_CLASSES.get(slo.strip().lower(), priority)
        xp = self.headers.get("X-Priority")
        if xp is not None:
            try:
                priority = int(xp)
            except ValueError:
                pass  # keep the SLO/body priority; a bad header is not fatal
        return priority

    def _stream_sse(self, app: dict, rid: int) -> None:
        """Server-sent events until the request reaches a terminal state.
        A broken pipe (client went away) cancels the request on the fleet
        so no orphaned decode burns slots."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("X-Request-Id", str(rid))
        self.end_headers()
        sent = 0
        try:
            while True:
                try:
                    s = app["stream"](rid)
                except KeyError:
                    self._sse("error", {"id": rid, "state": "unknown"})
                    return
                toks, lps = s.get("tokens") or [], s.get("lps") or []
                while sent < len(toks):
                    self._sse(
                        "token",
                        {
                            "id": rid,
                            "i": sent,
                            "token": toks[sent],
                            "lp": lps[sent] if sent < len(lps) else None,
                        },
                    )
                    sent += 1
                if s.get("state") in _TERMINAL_STATES:
                    if s["state"] in ("done", "cancelled"):
                        self._sse(
                            "done",
                            {
                                "id": rid,
                                "state": s["state"],
                                "tokens": toks,
                                "final": s.get("final"),
                                "lps": lps,
                            },
                        )
                    else:
                        self._sse(
                            "error",
                            {
                                "id": rid,
                                "state": s["state"],
                                "reason": s.get("lost_reason"),
                            },
                        )
                    return
                time.sleep(0.01)
        except (BrokenPipeError, ConnectionResetError, OSError):
            cancel = app.get("cancel")
            if cancel is not None:
                try:
                    cancel(rid)
                except (KeyError, RuntimeError):
                    # already finished or already gone — nothing to free
                    return

    def _wait_json(self, app: dict, rid: int, timeout: float) -> None:
        deadline = time.monotonic() + max(0.0, timeout)
        while True:
            try:
                s = app["stream"](rid)
            except KeyError:
                self._reply(404, b'{"error": "unknown request"}\n', "application/json")
                return
            if s.get("state") in _TERMINAL_STATES:
                break
            if time.monotonic() > deadline:
                body = json.dumps({"id": rid, "error": "timeout", "state": s.get("state")})
                self._reply(504, body.encode("utf-8"), "application/json")
                return
            time.sleep(0.01)
        if s["state"] in ("done", "cancelled"):
            body = json.dumps(
                {
                    "id": rid,
                    "state": s["state"],
                    "tokens": s.get("tokens") or [],
                    "final": s.get("final"),
                    "lps": s.get("lps") or [],
                },
                sort_keys=True,
            )
            self._reply(200, body.encode("utf-8"), "application/json")
        else:
            body = json.dumps(
                {"id": rid, "state": s["state"], "error": s.get("lost_reason") or s["state"]}
            )
            self._reply(500, body.encode("utf-8"), "application/json")

    def _sse(self, event: str, data: dict) -> None:
        chunk = f"event: {event}\ndata: {json.dumps(data)}\n\n"
        self.wfile.write(chunk.encode("utf-8"))
        self.wfile.flush()

    @staticmethod
    def _request_id(route: str) -> Optional[int]:
        try:
            return int(route.rsplit("/", 1)[1])
        except (IndexError, ValueError):
            return None

    def _reply(self, status: int, body: bytes, ctype: str):
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass


class TelemetryHTTPD:
    """Owns one ``ThreadingHTTPServer`` + its daemon accept thread.

    ``port=0`` binds an ephemeral port (tests); :meth:`start` returns
    the bound port. Usable as a context manager."""

    def __init__(
        self,
        *,
        metrics_fn: Callable[[], str],
        health_fn: Optional[Callable[[], dict]] = None,
        traces_fn: Optional[Callable[[int], list]] = None,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.host = host
        self.port = port
        self._app = {
            "metrics": metrics_fn,
            "health": health_fn if health_fn is not None else dict,
            "traces": traces_fn if traces_fn is not None else (lambda n: []),
            # inference surface: wired by for_supervisor(); None keeps the
            # /v1/* routes 404 on a pure-telemetry endpoint
            "submit": None,
            "cancel": None,
            "stream": None,
        }
        self._srv: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def for_router(cls, router, *, host: str = "127.0.0.1", port: int = 0) -> "TelemetryHTTPD":
        """Wire the three endpoints to a ``FleetRouter``: ``/metrics`` is
        ``router.prometheus_text`` verbatim, ``/healthz`` is
        ``router.health()``, ``/traces`` drains the router's tracer."""

        def traces(n: int) -> list:
            tracer = getattr(router, "tracer", None)
            return tracer.completed(n) if tracer is not None else []

        return cls(
            metrics_fn=router.prometheus_text,
            health_fn=router.health,
            traces_fn=traces,
            host=host,
            port=port,
        )

    @classmethod
    def for_supervisor(cls, supervisor, *, host: str = "127.0.0.1", port: int = 0) -> "TelemetryHTTPD":
        """The multi-process front door: telemetry endpoints plus the
        ``/v1/*`` inference surface, all wired to a
        :class:`~accelerate_tpu_torch.serving_proc.ProcessSupervisor`.
        ``/healthz`` reflects REAL worker-process liveness (503 on zero
        live workers); submit/cancel cross into the supervisor's pump
        thread through its command queue, and streams read its published
        snapshots — handler threads never touch a worker socket."""

        def submit(body: dict) -> int:
            return supervisor.submit(
                body["prompt"],
                max_new_tokens=body["max_new_tokens"],
                stop_sequences=body["stop_sequences"],
                priority=body["priority"],
                wait=True,
            )

        def traces(n: int) -> list:
            tracer = getattr(supervisor, "_tracer", None)
            return tracer.completed(n) if tracer is not None else []

        httpd = cls(
            metrics_fn=supervisor.prometheus_text,
            health_fn=supervisor.health,
            traces_fn=traces,
            host=host,
            port=port,
        )
        httpd._app["submit"] = submit
        httpd._app["cancel"] = supervisor.cancel
        httpd._app["stream"] = supervisor._stream
        return httpd

    # ------------------------------------------------------------------ #

    def start(self) -> int:
        """Bind (on the caller's thread, so the port is known before the
        accept thread exists) and start serving; returns the port."""
        if self._srv is not None:
            return self.port
        srv = ThreadingHTTPServer((self.host, self.port), _Handler)
        srv.daemon_threads = True
        srv.app = self._app
        thread = threading.Thread(target=_serve, args=(srv,), name="telemetry-httpd", daemon=True)
        thread.start()
        self._srv = srv
        self._thread = thread
        self.port = srv.server_address[1]
        return self.port

    def stop(self) -> None:
        """Shut down the accept loop and join the thread (caller's
        context, no lock held)."""
        srv, thread = self._srv, self._thread
        self._srv = None
        self._thread = None
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        if thread is not None:
            thread.join(timeout=5.0)

    def url(self, path: str = "/") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def __enter__(self) -> "TelemetryHTTPD":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
