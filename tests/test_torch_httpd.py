"""The port's HTTP front door (telemetry/httpd.py) against the JAX
package's: both driven by the same duck-typed supervisor give the same
status codes, JSON bodies, SSE event sequences and ``/metrics`` bytes on
every route; ``for_router`` over the port's in-process fleet serves its
``fleet_prometheus_text`` verbatim."""

import http.client
import json

import numpy as np
import pytest
import torch

import accelerate_tpu.telemetry.httpd as jhttpd
import accelerate_tpu_torch.telemetry.httpd as phttpd
from accelerate_tpu_torch import LlamaConfig, create_llama_model
from accelerate_tpu_torch.serving_fleet import FleetRouter
from accelerate_tpu_torch.telemetry import fleet_prometheus_text

torch.set_num_threads(2)

PROM = (
    "# HELP proc_worker_state worker health (0 healthy, 1 degraded, 2 quarantined, 3 dead, 4 spawning)\n"
    "# TYPE proc_worker_state gauge\n"
    'proc_worker_state{worker="w0"} 0\n'
    "proc_requests 3\n"
)


class _FakeTracer:
    def completed(self, n):
        return [{"trace_id": i, "status": "ok", "dur_ms": 1.5 * i} for i in range(3)][-n:] if n else []


class _FakeSupervisor:
    """Enough surface for TelemetryHTTPD.for_supervisor: request 0 is done
    with two tokens; request 1 streams three tokens over three reads; a
    prompt starting with 999 sheds, 998 fails with no worker."""

    def __init__(self, health):
        self._health = health
        self._tracer = _FakeTracer()
        self._streams = {}
        self._reads = {}
        self._next = 0
        self.submitted = []

    def submit(self, prompt, max_new_tokens, stop_sequences, priority, wait):
        if prompt[0] == 999:
            raise RuntimeError("request 7: shed: queue depth over its SLO")
        if prompt[0] == 998:
            raise RuntimeError("request 8: zero routable workers")
        rid = self._next
        self._next += 1
        self.submitted.append({"prompt": list(prompt), "max_new_tokens": max_new_tokens,
                               "stop_sequences": stop_sequences, "priority": priority, "wait": wait})
        self._streams[rid] = {"state": "done", "tokens": [5, 6], "lps": [-0.5, -0.25],
                              "final": list(prompt) + [5, 6], "lost_reason": None}
        if prompt[0] == 42:  # a stream that grows one token a read, then finishes
            self._streams[rid] = {"state": "routed", "tokens": [], "lps": [], "final": None, "lost_reason": None}
            self._reads[rid] = 0
        if prompt[0] == 41:  # lost at a failover
            self._streams[rid] = {"state": "lost", "tokens": [9], "lps": [-1.0], "final": None,
                                  "lost_reason": "no routable survivor after crash"}
        return rid

    def cancel(self, rid):
        s = self._streams[rid]
        s["state"] = "cancelled"
        return s["tokens"]

    def _stream(self, rid):
        s = self._streams[rid]
        if rid in self._reads and s["state"] == "routed":
            self._reads[rid] += 1
            n = self._reads[rid]
            s["tokens"] = [11, 12, 13][:n]
            s["lps"] = [-0.1, -0.2, -0.3][:n]
            if n == 3:
                s["state"] = "done"
                s["final"] = [42] + s["tokens"]
        return dict(s, tokens=list(s["tokens"]), lps=list(s["lps"]))

    def health(self):
        return self._health

    def prometheus_text(self):
        return PROM


def _call(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body) if not isinstance(body, bytes)
                     else body, headers=headers or {})
        r = conn.getresponse()
        raw = r.read()
        return r.status, r.getheader("Content-Type"), raw
    finally:
        conn.close()


def _parsed(ctype, raw):
    if ctype and ctype.startswith("text/event-stream"):
        return [(lines[0].split(": ", 1)[1], json.loads(lines[1].split(": ", 1)[1]))
                for block in raw.decode().strip().split("\n\n") if (lines := block.split("\n"))]
    if ctype and ctype.startswith("application/json"):
        return json.loads(raw)
    return raw


HEALTHY = {"w0": {"health": "healthy", "slot": 0}, "w1": {"health": "dead", "slot": 1}}
DOWN = {"w0": {"health": "dead", "slot": 0}, "w1.2": {"health": "quarantined", "slot": 1},
        "w2": {"health": "spawning", "slot": 2}}

# (health, [(method, path, body, headers)]): each sequence runs on fresh fakes
ROUTES = {
    "metrics": (HEALTHY, [("GET", "/metrics", None, None)]),
    "healthz_200": (HEALTHY, [("GET", "/healthz", None, None)]),
    "healthz_503": (DOWN, [("GET", "/healthz", None, None)]),
    "traces": (HEALTHY, [("GET", "/traces?n=2", None, None), ("GET", "/traces?n=bad", None, None)]),
    "unknown": (HEALTHY, [("GET", "/nope", None, None), ("POST", "/v2/generate", {}, None),
                          ("DELETE", "/v1/other/1", None, None)]),
    "generate_json": (HEALTHY, [("POST", "/v1/generate", {"prompt": [1, 2, 3], "max_new_tokens": 2}, None),
                                ("GET", "/v1/requests/0", None, None), ("GET", "/v1/requests/9", None, None),
                                ("GET", "/v1/requests/x", None, None)]),
    "priority_headers": (HEALTHY, [
        ("POST", "/v1/generate", {"prompt": [1], "priority": 2}, {"X-SLO-Class": "interactive"}),
        ("POST", "/v1/generate", {"prompt": [1], "priority": 2}, {"X-SLO-Class": "batch", "X-Priority": "5"}),
        ("POST", "/v1/generate", {"prompt": [1], "priority": 1}, {"X-Priority": "nope"}),
        ("POST", "/v1/generate", {"prompt": [1], "stop_sequences": [[4, 5]]}, {"X-SLO-Class": "unknown"})]),
    "bad_body": (HEALTHY, [("POST", "/v1/generate", b"not json", None), ("POST", "/v1/generate", {"x": 1}, None),
                           ("POST", "/v1/generate", {"prompt": ["a"]}, None)]),
    "shed_and_down": (HEALTHY, [("POST", "/v1/generate", {"prompt": [999]}, None),
                                ("POST", "/v1/generate", {"prompt": [998]}, None)]),
    "sse": (HEALTHY, [("POST", "/v1/generate", {"prompt": [42], "stream": True}, None),
                      ("POST", "/v1/generate", {"prompt": [1, 2]}, {"Accept": "text/event-stream"})]),
    "lost": (HEALTHY, [("POST", "/v1/generate", {"prompt": [41]}, None),
                       ("POST", "/v1/generate", {"prompt": [41], "stream": True}, None)]),
    "cancel": (HEALTHY, [("POST", "/v1/generate", {"prompt": [9]}, None), ("DELETE", "/v1/generate/0", None, None),
                         ("DELETE", "/v1/generate/99", None, None), ("DELETE", "/v1/generate/x", None, None)]),
}


def _replies(mod, health, calls):
    sup = _FakeSupervisor(health)
    httpd = mod.TelemetryHTTPD.for_supervisor(sup, port=0)
    httpd.start()
    try:
        out = []
        for method, path, body, headers in calls:
            status, ctype, raw = _call(httpd.port, method, path, body, headers)
            out.append((status, ctype, _parsed(ctype, raw)))
        return out, sup.submitted
    finally:
        httpd.stop()


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_front_door_replies_equal_jax(route):
    health, calls = ROUTES[route]
    got, got_submitted = _replies(phttpd, health, calls)
    want, want_submitted = _replies(jhttpd, health, calls)
    assert got == want
    assert got_submitted == want_submitted
    if route == "metrics":
        assert got[0][2] == PROM.encode()
    if route == "healthz_503":
        assert got[0][0] == 503 and got[0][2]["serving"] is False
    if route == "sse":
        assert [k for k, _ in got[0][2]] == ["token", "token", "token", "done"]
    assert phttpd.SLO_CLASSES == jhttpd.SLO_CLASSES


def test_for_router_serves_fleet_prometheus_text():
    """/metrics is the router's fleet_prometheus_text byte for byte, and
    /healthz its health rows, over a port fleet that served requests."""
    model = create_llama_model(LlamaConfig.tiny(), device="cpu")
    fr = FleetRouter.from_model(model, num_replicas=2, num_slots=2, prompt_buckets=(8,), max_len=64, device="cpu",
                                trace=True)
    fuids = [fr.submit(np.arange(1, 6 + i, dtype=np.int32), 3) for i in range(3)]
    assert sorted(fr.run()) == sorted(fuids)
    with phttpd.TelemetryHTTPD.for_router(fr) as httpd:
        status, ctype, raw = _call(httpd.port, "GET", "/metrics")
        assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
        assert raw.decode() == fleet_prometheus_text([r.engine.metrics for r in fr.replicas]) == fr.prometheus_text()
        status, _, raw = _call(httpd.port, "GET", "/healthz")
        assert status == 200 and json.loads(raw) == {"serving": True, "replicas": json.loads(json.dumps(fr.health()))}
        status, _, raw = _call(httpd.port, "GET", "/traces?n=2")
        traces = json.loads(raw)["traces"]
        assert status == 200 and len(traces) == 2 and all(t["status"] == "ok" for t in traces)
        # a telemetry-only endpoint has no inference routes
        assert _call(httpd.port, "POST", "/v1/generate", {"prompt": [1]})[0] == 404
    assert httpd._srv is None
