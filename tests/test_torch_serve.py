"""``python -m accelerate_tpu_torch.commands.serve`` end to end on the CPU:
the supervisor and two engine-worker processes behind the HTTP front
door. A JSON submit and an SSE stream give the JAX ``ServingEngine``'s
tokens (logprobs within 1e-5, f32); a stream is cancelled mid-decode;
``/metrics`` carries the workers' ``proc_worker_state``; ``/healthz``
answers 200, then 503 once no worker process lives; SIGTERM drains and
the command exits 0. Every wait has its own deadline and the server is
killed in a ``finally``."""

import http.client
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from torch_proc_harness import FACTORY, LP_ATOL, PAGED, REPO, WORKER_ENV, jax_reference, make_weights

PROMPT = [11, 4, 90, 3, 27]
NEW = 6


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return make_weights(tmp_path_factory.mktemp("weights"))


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _sse_events(resp, n_events, timeout_s=30.0):
    """Read SSE blocks from an http.client response until ``n_events`` or
    the stream ends."""
    buf, events = b"", []
    deadline = time.monotonic() + timeout_s
    while len(events) < n_events and time.monotonic() < deadline:
        chunk = resp.read1(4096)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            block, buf = buf.split(b"\n\n", 1)
            lines = block.decode().split("\n")
            events.append((lines[0].split(": ", 1)[1], json.loads(lines[1].split(": ", 1)[1])))
    return events


def test_serve_end_to_end_http_sse_cancel_drain(weights, tmp_path):
    _, path, config = weights
    [[(want, want_lps)]] = jax_reference(weights[0], ([np.asarray(PROMPT, np.int32)], NEW))
    ready = tmp_path / "ready.json"
    log = open(tmp_path / "serve.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "accelerate_tpu_torch.commands.serve", "--device", "cpu", "--workers", "2",
         "--run-dir", str(tmp_path / "run"), "--http-port", "0", "--model-spec", FACTORY,
         "--model-kwargs", json.dumps({"path": path, "config": config, "delay_s": 0.01}),
         "--engine-kwargs", json.dumps(PAGED), "--ready-file", str(ready), "--max-respawns", "0",
         "--max-runtime-s", "240"],
        env=dict(os.environ, **WORKER_ENV), cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
    )
    worker_pids = []
    try:
        deadline = time.monotonic() + 120
        while not ready.exists() and time.monotonic() < deadline:
            assert proc.poll() is None, open(tmp_path / "serve.log").read()
            time.sleep(0.1)
        assert ready.exists(), "serve never became ready"
        port = json.loads(ready.read_text())["http_port"]

        status, body = _get(port, "/healthz")
        rows = json.loads(body)["replicas"]
        worker_pids = [row["pid"] for row in rows.values()]
        assert status == 200 and sorted(rows) == ["w0", "w1"] and all(r["health"] == "healthy" for r in rows.values())

        # a JSON submit waits for the result: the JAX engine's tokens
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v1/generate", body=json.dumps({"prompt": PROMPT, "max_new_tokens": NEW}))
        r = conn.getresponse()
        out = json.loads(r.read())
        conn.close()
        assert r.status == 200 and out["state"] == "done"
        np.testing.assert_array_equal(out["final"], want)
        np.testing.assert_allclose(out["lps"], want_lps, atol=LP_ATOL, rtol=0)

        # an SSE stream of the same prompt: one token event a token, then done, the same tokens
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v1/generate", body=json.dumps({"prompt": PROMPT, "max_new_tokens": NEW}),
                     headers={"Accept": "text/event-stream"})
        r = conn.getresponse()
        assert r.getheader("Content-Type", "").startswith("text/event-stream")
        events = _sse_events(r, NEW + 1)
        conn.close()
        assert [k for k, _ in events] == ["token"] * NEW + ["done"]
        assert [d["token"] for _, d in events[:NEW]] == out["tokens"] == list(want[len(PROMPT):])
        np.testing.assert_allclose([d["lp"] for _, d in events[:NEW]], want_lps, atol=LP_ATOL, rtol=0)

        # a long stream cancelled from the side ends "cancelled"
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v1/generate", body=json.dumps({"prompt": [5, 6, 7], "max_new_tokens": 48,
                                                              "stream": True}))
        r = conn.getresponse()
        rid = int(r.getheader("X-Request-Id"))
        side = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        side.request("DELETE", f"/v1/generate/{rid}")
        cancelled = side.getresponse()
        reply = json.loads(cancelled.read())
        side.close()
        assert cancelled.status == 200 and reply["cancelled"] is True
        tail = _sse_events(r, 64)
        conn.close()
        assert tail and tail[-1][0] == "done" and tail[-1][1]["state"] == "cancelled"
        assert len(tail[-1][1]["tokens"]) < 48

        status, body = _get(port, "/metrics")
        assert status == 200 and b'proc_worker_state{worker="w0"} 0' in body and b"proc_done 2" in body

        # no worker process left: /healthz flips to 503
        for pid in worker_pids:
            os.kill(pid, signal.SIGKILL)
        deadline = time.monotonic() + 30
        while _get(port, "/healthz")[0] != 503 and time.monotonic() < deadline:
            time.sleep(0.05)
        status, body = _get(port, "/healthz")
        assert status == 503 and json.loads(body)["serving"] is False

        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, open(tmp_path / "serve.log").read()
        assert "[serve] drained, exit 0" in open(tmp_path / "serve.log").read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        for pid in worker_pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        log.close()
