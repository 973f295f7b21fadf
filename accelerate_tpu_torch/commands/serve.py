"""``serve``: run the multi-process serving fleet.

Counterpart of ``accelerate-tpu serve`` (:mod:`accelerate_tpu.commands.serve`),
run as ``python -m accelerate_tpu_torch.commands.serve``. Starts the
:class:`~accelerate_tpu_torch.serving_proc.ProcessSupervisor` (engine
workers as subprocesses on the card unless ``--device cpu``; the serving
kernels built once before the first spawn, so every worker builds none)
behind the HTTP/SSE front door
(:class:`~accelerate_tpu_torch.telemetry.httpd.TelemetryHTTPD`). An HTTP
client can then submit (``POST /v1/generate``), stream tokens over SSE,
cancel (``DELETE /v1/generate/<id>``), and scrape ``/metrics`` /
``/healthz`` (503 on zero live worker processes). SIGTERM (or Ctrl-C)
drains: in-flight requests complete or migrate, workers shut down, exit 0.

Example::

    python -m accelerate_tpu_torch.commands.serve --workers 2 --run-dir /tmp/fleet --http-port 8799
    curl -N -H 'Accept: text/event-stream' \\
         -d '{"prompt": [1,2,3], "max_new_tokens": 8}' \\
         http://127.0.0.1:8799/v1/generate
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile


def serve_parser(subparsers=None):
    if subparsers is not None:
        parser = subparsers.add_parser("serve", help="Run the multi-process serving fleet behind the HTTP/SSE front door")
    else:
        parser = argparse.ArgumentParser("python -m accelerate_tpu_torch.commands.serve")
    parser.add_argument("--workers", type=int, default=2, help="Engine worker processes")
    parser.add_argument(
        "--model-spec", default="accelerate_tpu_torch.serving_proc:default_model",
        help="'module:callable' model factory run in each worker (must be seeded/deterministic)",
    )
    parser.add_argument("--model-kwargs", default=None, help="JSON kwargs for the model factory")
    parser.add_argument("--engine-kwargs", default=None, help="JSON kwargs for each worker's ServingEngine")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Where the workers serve (the card unless cpu is asked for)")
    parser.add_argument("--run-dir", default=os.path.join(tempfile.gettempdir(), "accelerate_tpu_torch_serve"),
                        help="Run artifacts: per-worker eventlogs, flight dumps, worker logs")
    parser.add_argument("--store-dir", default=None,
                        help="Executable store the workers' program caches share (default: {run-dir}/store)")
    parser.add_argument("--http-host", default="127.0.0.1", help="Front-door bind host")
    parser.add_argument("--http-port", type=int, default=8799, help="Front-door port (0 = ephemeral)")
    parser.add_argument("--shadow-kv", action="store_true", help="Ship KV rows in failover snapshots")
    parser.add_argument("--max-respawns", type=int, default=3, help="Respawns a worker slot may take")
    parser.add_argument("--ready-file", default=None,
                        help="Write {http_port, pid} JSON here once serving (test harnesses)")
    parser.add_argument("--max-runtime-s", type=float, default=None,
                        help="Self-drain after this many seconds (test harnesses)")
    parser.set_defaults(func=serve_command)
    return parser


def serve_command(args) -> int:
    from accelerate_tpu_torch.serving_proc import ProcConfig, serve

    config = ProcConfig(
        workers=args.workers,
        model_spec=args.model_spec,
        model_kwargs=json.loads(args.model_kwargs) if args.model_kwargs else None,
        engine=json.loads(args.engine_kwargs) if args.engine_kwargs else None,
        device=args.device,
        run_dir=args.run_dir,
        store_dir=args.store_dir,
        shadow_kv=args.shadow_kv,
        max_respawns=args.max_respawns,
    )
    print(f"[serve] supervisor: {config.workers} workers on {config.device}, run_dir={config.run_dir}", flush=True)
    rc = serve(
        config,
        http_host=args.http_host,
        http_port=args.http_port,
        ready_file=args.ready_file,
        max_runtime_s=args.max_runtime_s,
    )
    print(f"[serve] drained, exit {rc}", flush=True)
    return rc


def main():
    args = serve_parser().parse_args()
    raise SystemExit(args.func(args))


if __name__ == "__main__":
    main()
