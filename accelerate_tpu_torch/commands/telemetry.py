"""``telemetry``: summarize a run's JSONL event log, or self-check the
runtime-telemetry pipeline.

Counterpart of ``accelerate-tpu telemetry``
(:mod:`accelerate_tpu.commands.telemetry`), run as
``python -m accelerate_tpu_torch.commands.telemetry``.

``summarize`` parses a telemetry file (written by ``Accelerator.telemetry``
/ :class:`~accelerate_tpu_torch.telemetry.Telemetry`) and renders step-time
p50/p95, the data-wait/dispatch/execute split, first-use time, recompile
count (with the changed shapes), MFU, goodput, peak device memory and
serving counters; reading needs no card.

``selfcheck`` runs a 5-step loop with the watchdog armed (including a
deliberate shape change) on the card unless ``--device cpu`` is asked for,
writes the JSONL, parses it again, and asserts the summary holds what it
should.

Examples::

    python -m accelerate_tpu_torch.commands.telemetry summarize run.jsonl
    python -m accelerate_tpu_torch.commands.telemetry summarize run.jsonl --format json
    python -m accelerate_tpu_torch.commands.telemetry selfcheck
"""

from __future__ import annotations

import argparse
import json
import os


def telemetry_parser(subparsers=None):
    if subparsers is not None:
        parser = subparsers.add_parser("telemetry", help="Summarize or self-check runtime telemetry JSONL event logs")
    else:
        parser = argparse.ArgumentParser("python -m accelerate_tpu_torch.commands.telemetry")
    sub = parser.add_subparsers(dest="telemetry_command", required=True)

    p_sum = sub.add_parser("summarize", help="Render a telemetry JSONL file as a run report")
    p_sum.add_argument("path", help="telemetry JSONL file (e.g. runs/telemetry.jsonl)")
    p_sum.add_argument("--format", choices=("text", "json"), default="text", help="Report format")
    p_sum.add_argument("--strict", action="store_true",
                       help="Exit nonzero when the run recorded warnings (recompiles, memory drift)")
    p_sum.set_defaults(telemetry_func=summarize_command)

    p_check = sub.add_parser("selfcheck", help="Prove the telemetry pipeline works, on the card unless --device cpu")
    p_check.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help="Where the loop runs")
    p_check.set_defaults(telemetry_func=selfcheck_command)

    parser.set_defaults(func=lambda args: args.telemetry_func(args))
    return parser


def summarize_command(args) -> int:
    if not os.path.exists(args.path):
        print(f"no such file: {args.path}")
        return 2
    from accelerate_tpu_torch.telemetry import render_text, summarize_file

    report = summarize_file(args.path)
    if args.format == "json":
        print(json.dumps(report, indent=2))
    else:
        print(render_text(report))
    if args.strict and report.get("warnings"):
        return 1
    return 0


def selfcheck_command(args) -> int:
    """5 steps + one shape change -> JSONL -> parse -> summarize; nonzero
    on any broken link in that chain."""
    import tempfile

    import torch

    from accelerate_tpu_torch.telemetry import Telemetry, read_events, render_text, summarize
    from accelerate_tpu_torch.utils.environment import resolve_device

    device = resolve_device(getattr(args, "device", None) or "cuda")
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "run.jsonl")
        tel = Telemetry(path, rank=0, hbm_sample_every=1, flops_per_step=2 * 64 * 64 * 64,
                        peak_flops_per_device=1e12)
        step = tel.wrap(lambda x: (x @ x).sum())
        x = torch.ones((64, 64), dtype=torch.float32, device=device)
        for _ in range(5):
            step(x)
        step(torch.ones((32, 32), dtype=torch.float32, device=device))  # a new shape after warm-up
        tel.close()

        events = read_events(path)
        if not events:
            failures.append("event log is empty or unparseable")
        if any(e.get("v") != 1 or "ts" not in e or "rank" not in e for e in events):
            failures.append("schema fields missing on some records")
        report = summarize(events)
        steps = report.get("steps") or {}
        if steps.get("count") != 6:
            failures.append(f"expected 6 step spans, got {steps.get('count')}")
        if steps.get("recompiles") != 1:
            failures.append(f"expected exactly 1 recompile, got {steps.get('recompiles')}")
        if steps.get("p50_step_ms") is None or steps.get("p95_step_ms") is None:
            failures.append("step-time percentiles missing")
        if steps.get("compile_ms", 0) <= 0:
            failures.append("first-use attribution missing")
        print(render_text(report))

    for msg in failures:
        print(f"[telemetry selfcheck] FAILED: {msg}")
    if not failures:
        print(f"[telemetry selfcheck] OK on {device.type}: log schema, step split, watchdog, summarize")
    return 1 if failures else 0


def main():
    args = telemetry_parser().parse_args()
    raise SystemExit(args.telemetry_func(args))


if __name__ == "__main__":
    main()
