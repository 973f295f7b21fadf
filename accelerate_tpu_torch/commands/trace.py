"""``trace``: read the request-tracing side of a telemetry JSONL file:
per-request critical paths, Perfetto exports, and crash flight-recorder
dumps.

Counterpart of ``accelerate-tpu trace`` (:mod:`accelerate_tpu.commands.trace`),
run as ``python -m accelerate_tpu_torch.commands.trace``; stdlib only, no
card needed.

``summarize`` reconstructs completed traces from their ``trace.*`` span
records and renders the critical-path table (segment p50/p95, share of
end-to-end latency) plus any latched ``trace_drift`` warnings. The path
may be a supervisor run dir: its per-process ``events_*.jsonl`` logs
merge deterministically.

``export`` converts the same records to Chrome trace-event JSON (load it
in Perfetto or ``chrome://tracing``).

``flight-dump`` pretty-prints a flight-recorder dump file written by a
crashed or quarantined replica or worker.

``selfcheck`` proves the drift latch end to end with a seeded fixture: a
trace whose handoff moved fewer bytes than priced latches exactly ONE
``trace_drift``, and a clean twin latches none.

Examples::

    python -m accelerate_tpu_torch.commands.trace summarize runs/telemetry.jsonl
    python -m accelerate_tpu_torch.commands.trace export runs/telemetry.jsonl -o trace.json
    python -m accelerate_tpu_torch.commands.trace flight-dump /tmp/fleet/flight_w1.json
    python -m accelerate_tpu_torch.commands.trace selfcheck
"""

from __future__ import annotations

import argparse
import json
import os


def trace_parser(subparsers=None):
    if subparsers is not None:
        parser = subparsers.add_parser("trace", help="Request traces: critical paths, Perfetto export, flight dumps")
    else:
        parser = argparse.ArgumentParser("python -m accelerate_tpu_torch.commands.trace")
    sub = parser.add_subparsers(dest="trace_command", required=True)

    p_sum = sub.add_parser("summarize", help="Critical-path decomposition of a traced run")
    p_sum.add_argument(
        "path",
        help="telemetry JSONL file with trace.* records, or a supervisor run "
        "dir (its events_*.jsonl per-process logs merge deterministically)",
    )
    p_sum.add_argument("--format", choices=("text", "json"), default="text", help="Report format")
    p_sum.add_argument("--strict", action="store_true", help="Exit nonzero when any trace_drift warning latched")
    p_sum.set_defaults(trace_func=summarize_command)

    p_exp = sub.add_parser("export", help="Export traces as Chrome trace-event JSON (Perfetto)")
    p_exp.add_argument("path", help="telemetry JSONL file with trace.* records, or a supervisor run dir")
    p_exp.add_argument("-o", "--output", default=None, help="Output file (default: stdout)")
    p_exp.set_defaults(trace_func=export_command)

    p_fd = sub.add_parser("flight-dump", help="Render a flight-recorder dump file")
    p_fd.add_argument("path", help="flight dump JSON written on a replica's fatal transition")
    p_fd.add_argument("--format", choices=("text", "json"), default="text", help="Report format")
    p_fd.add_argument("--tail", type=int, default=16, help="Ring-buffer events to show")
    p_fd.set_defaults(trace_func=flight_dump_command)

    p_check = sub.add_parser("selfcheck", help="Seeded drift fixture + clean twin through the whole trace pipeline")
    p_check.set_defaults(trace_func=selfcheck_command)

    parser.set_defaults(func=lambda args: args.trace_func(args))
    return parser


def _load_events(path: str):
    """One telemetry JSONL, or a supervisor run dir whose per-process
    ``events_*.jsonl`` logs merge deterministically (``seq`` counters are
    per-process; ``merge_events`` disambiguates by the worker id each
    filename carries). None when nothing is readable."""
    from accelerate_tpu_torch.telemetry.eventlog import merge_events, read_events

    if os.path.isfile(path):
        return read_events(path)
    if os.path.isdir(path):
        import glob

        files = sorted(glob.glob(os.path.join(path, "events_*.jsonl")))
        if not files:
            return None
        sources = [os.path.basename(f)[len("events_"):-len(".jsonl")] for f in files]
        return merge_events(*[read_events(f) for f in files], source_ids=sources)
    return None


def summarize_command(args) -> int:
    from accelerate_tpu_torch.telemetry.critpath import decompose, render_critpath
    from accelerate_tpu_torch.telemetry.trace import traces_from_events

    events = _load_events(args.path)
    if events is None:
        print(f"no telemetry at: {args.path}")
        return 2
    traces = traces_from_events(events)
    drift = [
        {
            "segment": e.get("segment"), "check": e.get("check"),
            "observed": e.get("observed"), "predicted": e.get("predicted"),
            "rel_error": e.get("rel_error", 0.0), "trace": e.get("trace"),
        }
        for e in events
        if e.get("kind") == "event" and e.get("name") == "trace_drift"
    ]
    report = decompose(traces)
    if args.format == "json":
        report["drift_events"] = drift
        print(json.dumps(report, indent=2, default=repr))
    else:
        print(render_critpath(report, drift=drift))
    if args.strict and drift:
        return 1
    return 0


def export_command(args) -> int:
    from accelerate_tpu_torch.telemetry.trace import chrome_trace, traces_from_events

    events = _load_events(args.path)
    if events is None:
        print(f"no telemetry at: {args.path}")
        return 2
    traces = traces_from_events(events)
    doc = chrome_trace(traces)
    text = json.dumps(doc, default=repr)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
        print(f"wrote {len(doc['traceEvents'])} trace events ({len(traces)} traces) to {args.output}")
    else:
        print(text)
    return 0


def flight_dump_command(args) -> int:
    if not os.path.exists(args.path):
        print(f"no such file: {args.path}")
        return 2
    from accelerate_tpu_torch.telemetry.flightrec import read_dump, render_dump

    doc = read_dump(args.path)
    if args.format == "json":
        print(json.dumps(doc, indent=2, default=repr))
    else:
        print(render_dump(doc, tail=args.tail))
    return 0


def selfcheck_command(args) -> int:
    """Seeded drift fixture + clean twin: a fake-clock Tracer drives one
    handoff trace whose moved bytes undercut the price (MUST latch exactly
    one trace_drift) and one honest twin (MUST stay silent); exports must
    round-trip through ``traces_from_events`` and ``chrome_trace``."""
    import tempfile

    from accelerate_tpu_torch.telemetry.critpath import CritPathMonitor, decompose
    from accelerate_tpu_torch.telemetry.eventlog import EventLog, read_events
    from accelerate_tpu_torch.telemetry.flightrec import FlightRecorder
    from accelerate_tpu_torch.telemetry.trace import Tracer, chrome_trace, traces_from_events

    failures = []

    def run(moved_bytes: int, tmp: str, label: str):
        t = [0.0]

        def clock():
            t[0] += 0.010
            return t[0]

        path = os.path.join(tmp, f"{label}.jsonl")
        log = EventLog(path, rank=0)
        mon = CritPathMonitor(log)
        fr = FlightRecorder(64, name=label)
        log.add_tap(fr.record)
        tracer = Tracer(clock=clock, log=log, on_finish=mon.observe)
        tid = tracer.start(fuid=0)
        tracer.seg(tid, "queue_wait", accounted_ms=10.0)
        tracer.seg(tid, "admit")
        tracer.seg(tid, "prefill", tokens=8)
        tracer.seg(tid, "kv_handoff", tokens=8, moved_bytes=moved_bytes, predicted_bytes=4096)
        tracer.window(tid, "decode", tokens=4)
        tracer.finish(tid, status="ok")
        log.close()
        return mon, fr, path

    with tempfile.TemporaryDirectory() as tmp:
        mon, fr, path = run(2048, tmp, "drift")  # moved != predicted: must latch
        if list(mon.drift_events) != ["kv_handoff"]:
            failures.append(f"seeded byte drift did not latch: {list(mon.drift_events)}")
        events = read_events(path)
        if not any(e.get("name") == "trace_drift" for e in events):
            failures.append("trace_drift event missing from the log")
        traces = traces_from_events(events)
        if len(traces) != 1 or traces[0]["status"] != "ok":
            failures.append(f"trace reconstruction broken: {traces}")
        report = decompose(traces)
        if set(report["by_class"]) != {"queue_wait", "admit", "prefill", "kv_handoff", "decode"}:
            failures.append(f"decompose lost segments: {sorted(report['by_class'])}")
        doc = chrome_trace(traces)
        if not any(ev.get("ph") == "X" for ev in doc["traceEvents"]):
            failures.append("chrome export has no duration events")
        if not fr.tail():
            failures.append("flight recorder tap recorded nothing")
        dump = fr.dump(reason="selfcheck")
        if not dump["events"]:
            failures.append("flight dump dropped the ring")

        clean, _, _ = run(4096, tmp, "clean")  # honest twin: silence
        if clean.drift_events:
            failures.append(f"clean twin latched drift: {list(clean.drift_events)}")

    for msg in failures:
        print(f"[trace selfcheck] FAILED: {msg}")
    if not failures:
        print(
            "[trace selfcheck] OK: drift fixture latched once, clean twin silent, "
            "reconstruction + chrome export + flight recorder round-trip"
        )
    return 1 if failures else 0


def main():
    args = trace_parser().parse_args()
    raise SystemExit(args.trace_func(args))


if __name__ == "__main__":
    main()
