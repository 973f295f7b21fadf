"""Turn a telemetry JSONL file into the run's story: step-time
percentiles, compile vs execute vs data-wait, recompile count, MFU, HBM
peak (observed AND statically predicted), and serving counters.

A copy of :mod:`accelerate_tpu.telemetry.summarize` (stdlib only),
kept here so the port imports nothing of the JAX package. Its ``steps``
section reads the port's step records, whose recompile watchdog compares
input signatures only (``compile`` marks a step whose signature was new).

This is the offline half of the subsystem — everything here works on a
plain list of parsed records, no backend. Each package's ``summarize``
reads the other's event logs (one schema).
"""

from __future__ import annotations

from typing import Optional

from .eventlog import read_events


def _pct(sorted_vals, q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    k = max(0, min(len(sorted_vals) - 1, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return round(sorted_vals[k], 3)


def _mean(vals) -> Optional[float]:
    vals = list(vals)
    return round(sum(vals) / len(vals), 3) if vals else None


def summarize(events: list[dict]) -> dict:
    """Aggregate parsed telemetry records into one report dict. Sections
    (``steps`` / ``hbm`` / ``serving``) appear only when the run emitted
    the corresponding records, so training-only and serving-only files
    both summarize cleanly."""
    report: dict = {"events": len(events)}

    steps = [e for e in events if e.get("kind") == "span" and e.get("name") == "step"]
    if steps:
        steady = [s for s in steps if not s.get("compile")]
        durs = sorted(s.get("dur_ms", 0.0) for s in steady)
        compile_ms = sum(s.get("dispatch_ms", 0.0) for s in steps if s.get("compile"))
        recompiles = [e for e in events if e.get("kind") == "event" and e.get("name") == "recompile"]
        mfus = [s["mfu"] for s in steady if "mfu" in s]
        total = sum(s.get("dur_ms", 0.0) for s in steady)
        busy = sum(s.get("dispatch_ms", 0.0) + s.get("execute_ms", 0.0) for s in steady)
        static_step = next(
            (e for e in events if e.get("kind") == "event" and e.get("name") == "perf_static_estimate"),
            None,
        )
        perf_drift = [
            e for e in events if e.get("kind") == "event" and e.get("name") == "perf_model_drift"
        ]
        report["steps"] = {
            "count": len(steps),
            "steady_count": len(steady),
            "p50_step_ms": _pct(durs, 50),
            "p95_step_ms": _pct(durs, 95),
            "mean_data_wait_ms": _mean(s.get("data_wait_ms", 0.0) for s in steady),
            "mean_dispatch_ms": _mean(s.get("dispatch_ms", 0.0) for s in steady),
            "mean_execute_ms": _mean(s.get("execute_ms", 0.0) for s in steady),
            "compile_ms": round(compile_ms, 3),
            "recompiles": len(recompiles),
            "recompile_details": [
                {"step": e.get("step"), "changed": e.get("changed")} for e in recompiles
            ],
            "goodput": round(min(1.0, busy / total), 4) if total > 0 else None,
            "mfu": round(sum(mfus) / len(mfus), 5) if mfus else None,
            # static roofline cross-check (perf-check seeds the estimate,
            # StepTelemetry emits perf_model_drift on disagreement)
            "static_step_ms": static_step.get("predicted_ms") if static_step else None,
            "perf_drift_events": [
                {
                    "predicted_ms": e.get("predicted_ms"),
                    "observed_busy_ms": e.get("observed_busy_ms"),
                    "rel_error": e.get("rel_error"),
                }
                for e in perf_drift
            ],
        }

    hbm_counters = [e for e in events if e.get("kind") == "counter" and e.get("name") == "hbm_peak_bytes"]
    static = next(
        (e for e in events if e.get("kind") == "event" and e.get("name") == "hbm_static_estimate"), None
    )
    drift = [e for e in events if e.get("kind") == "event" and e.get("name") == "hbm_drift"]
    if hbm_counters or static:
        observed = max((e.get("value", 0) for e in hbm_counters), default=None)
        limits = [e.get("bytes_limit") for e in hbm_counters if e.get("bytes_limit")]
        report["hbm"] = {
            "observed_peak_bytes": observed,
            "static_peak_bytes": static.get("bytes") if static else None,
            "bytes_limit": max(limits) if limits else None,
            "headroom_bytes": (max(limits) - observed) if (limits and observed is not None) else None,
            "drift_events": [
                {
                    "observed_peak_bytes": e.get("observed_peak_bytes"),
                    "static_peak_bytes": e.get("static_peak_bytes"),
                    "rel_error": e.get("rel_error"),
                }
                for e in drift
            ],
        }

    serving = {}
    for e in events:
        if e.get("kind") == "counter" and str(e.get("name", "")).startswith("serving."):
            serving[e["name"][len("serving."):]] = e.get("value")  # last write wins
    if serving:
        report["serving"] = serving

    # scheduler decisions (serving.py + scheduling.py): every admit /
    # shed / preempt_decode / resume lands as one event with priority and
    # queue wait attached, so the report can say WHICH class paid
    sched = {name: [e for e in events if e.get("kind") == "event" and e.get("name") == name]
             for name in ("admit", "shed", "preempt_decode", "resume")}
    if any(sched.values()):
        waits = [e["queue_wait_ms"] for e in sched["admit"] if e.get("queue_wait_ms") is not None]
        report["scheduler"] = {
            "admitted": len(sched["admit"]),
            "shed": len(sched["shed"]),
            "preempted": len(sched["preempt_decode"]),
            "resumed": len(sched["resume"]),
            "mean_queue_wait_ms": _mean(waits),
            "p95_queue_wait_ms": _pct(sorted(waits), 95),
            "shed_by_priority": {
                str(p): sum(1 for e in sched["shed"] if e.get("priority") == p)
                for p in sorted({e.get("priority") for e in sched["shed"]})
            },
        }

    # compile cache (aot/): hit/miss/deserialize + per-bucket serving builds
    cc_hits = [e for e in events if e.get("kind") == "event" and e.get("name") == "compile_cache_hit"]
    cc_miss = [e for e in events if e.get("kind") == "event" and e.get("name") == "compile_cache_miss"]
    cc_rej = [e for e in events if e.get("kind") == "event" and e.get("name") == "compile_cache_reject"]
    buckets = [e for e in events if e.get("kind") == "event" and e.get("name") == "serving_bucket_compile"]
    if cc_hits or cc_miss or cc_rej or buckets:
        report["compile_cache"] = {
            "hits": len(cc_hits),
            "disk_hits": sum(1 for e in cc_hits if e.get("source") == "disk"),
            "misses": len(cc_miss),
            "rejected": len(cc_rej),
            "compile_ms": round(sum(e.get("compile_ms", 0.0) for e in cc_miss), 3),
            "deserialize_ms": round(sum(e.get("deserialize_ms", 0.0) for e in cc_hits), 3),
            "bucket_compiles": [
                {"program": e.get("program"), "bucket": e.get("bucket"), "compile_ms": e.get("compile_ms")}
                for e in buckets
            ],
        }

    # non-finite watchdog (the runtime counterpart of numerics TPU602):
    # the latched `nonfinite` event + the fp16 loss-scale trajectory
    nonfinite = [e for e in events if e.get("kind") == "event" and e.get("name") == "nonfinite"]
    scales = [e for e in events if e.get("kind") == "event" and e.get("name") == "loss_scale"]
    if nonfinite or scales:
        scale_vals = [e.get("scale") for e in scales if e.get("scale") is not None]
        report["nonfinite"] = {
            "events": [
                {
                    "step": e.get("step"),
                    "leaf": e.get("leaf"),
                    "value": e.get("value"),
                    "loss_scale": e.get("loss_scale"),
                }
                for e in nonfinite
            ],
            "loss_scale": {
                "current": scale_vals[-1] if scale_vals else None,
                "min": min(scale_vals) if scale_vals else None,
                "max": max(scale_vals) if scale_vals else None,
                "backoffs": max((e.get("backoffs", 0) for e in scales), default=0),
                "changes": len(scales),
            }
            if scales
            else None,
        }

    # request traces (telemetry.trace): reconstruct completed traces from
    # their span + trace_complete records, decompose the critical path,
    # and surface the latched trace_drift warnings + flight-recorder dumps
    trace_complete = [
        e for e in events if e.get("kind") == "event" and e.get("name") == "trace_complete"
    ]
    if trace_complete:
        from .critpath import decompose
        from .trace import traces_from_events

        traces = traces_from_events(events)
        tdrift = [e for e in events if e.get("kind") == "event" and e.get("name") == "trace_drift"]
        dumps = [e for e in events if e.get("kind") == "event" and e.get("name") == "flight_dump"]
        decomp = decompose(traces)
        report["traces"] = {
            "count": decomp["count"],
            "completed": decomp["completed"],
            "by_class": decomp["by_class"],
            "drift_events": [
                {
                    "segment": e.get("segment"),
                    "check": e.get("check"),
                    "observed": e.get("observed"),
                    "predicted": e.get("predicted"),
                    "rel_error": e.get("rel_error"),
                    "trace": e.get("trace"),
                }
                for e in tdrift
            ],
            "flight_dumps": len(dumps),
        }

    warnings = [
        e for e in events
        if e.get("kind") == "event" and e.get("severity") in ("warning", "error")
    ]
    report["warnings"] = len(warnings)
    return report


def summarize_file(path: str) -> dict:
    return summarize(read_events(path))


def _human_bytes(n) -> str:
    if n is None:
        return "n/a"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n:.1f} TiB"


def render_text(report: dict) -> str:
    """Human-readable report (the ``--format text`` default)."""
    lines = [f"telemetry summary ({report.get('events', 0)} records, "
             f"{report.get('warnings', 0)} warnings)"]
    steps = report.get("steps")
    if steps:
        lines.append("  steps:")
        lines.append(
            f"    step time         : p50 {steps['p50_step_ms']} ms / p95 {steps['p95_step_ms']} ms "
            f"({steps['steady_count']} steady of {steps['count']})"
        )
        lines.append(
            f"    split (mean)      : data-wait {steps['mean_data_wait_ms']} ms | "
            f"dispatch {steps['mean_dispatch_ms']} ms | execute {steps['mean_execute_ms']} ms"
        )
        lines.append(f"    compile           : {steps['compile_ms']} ms")
        lines.append(f"    recompiles        : {steps['recompiles']}")
        for d in steps.get("recompile_details", []):
            for change in d.get("changed") or []:
                lines.append(f"      step {d.get('step')}: {change}")
        if steps.get("goodput") is not None:
            lines.append(f"    goodput           : {steps['goodput']:.1%}")
        if steps.get("mfu") is not None:
            lines.append(f"    MFU               : {steps['mfu']:.1%}")
        if steps.get("static_step_ms") is not None:
            lines.append(f"    static prediction : {steps['static_step_ms']} ms (perf-check roofline)")
        for d in steps.get("perf_drift_events", []):
            lines.append(
                f"    DRIFT: observed busy {d['observed_busy_ms']} ms vs "
                f"predicted {d['predicted_ms']} ms ({d['rel_error']:.0%} off)"
            )
    hbm = report.get("hbm")
    if hbm:
        lines.append("  hbm:")
        lines.append(f"    observed peak     : {_human_bytes(hbm['observed_peak_bytes'])}")
        lines.append(f"    static estimate   : {_human_bytes(hbm['static_peak_bytes'])}")
        if hbm.get("headroom_bytes") is not None:
            lines.append(f"    headroom          : {_human_bytes(hbm['headroom_bytes'])}")
        for d in hbm.get("drift_events", []):
            lines.append(
                f"    DRIFT: observed {_human_bytes(d['observed_peak_bytes'])} vs "
                f"static {_human_bytes(d['static_peak_bytes'])} ({d['rel_error']:.0%} off)"
            )
    serving = report.get("serving")
    if serving:
        lines.append("  serving:")
        order = (
            "requests_submitted", "requests_completed", "requests_cancelled",
            "tokens_generated", "tokens_per_sec", "ttft_ms_p50", "ttft_ms_p95",
            "queue_depth", "kv_block_utilization", "preemptions",
        )
        for key in order:
            if key in serving and serving[key] is not None:
                val = serving[key]
                lines.append(f"    {key:<18}: {val:.3f}" if isinstance(val, float) else f"    {key:<18}: {val}")
        for key, val in serving.items():
            if key not in order and val is not None:
                lines.append(f"    {key:<18}: {val}")
    sched = report.get("scheduler")
    if sched:
        lines.append("  scheduler:")
        lines.append(
            f"    decisions         : {sched['admitted']} admitted | {sched['shed']} shed | "
            f"{sched['preempted']} preempted | {sched['resumed']} resumed"
        )
        if sched.get("mean_queue_wait_ms") is not None:
            lines.append(
                f"    queue wait        : mean {sched['mean_queue_wait_ms']} ms / "
                f"p95 {sched['p95_queue_wait_ms']} ms"
            )
        for prio, n in (sched.get("shed_by_priority") or {}).items():
            lines.append(f"    shed priority {prio}   : {n}")
    cc = report.get("compile_cache")
    if cc:
        lines.append("  compile cache:")
        lines.append(
            f"    hits              : {cc['hits']} ({cc['disk_hits']} from disk, "
            f"{cc['deserialize_ms']} ms deserializing)"
        )
        lines.append(f"    misses            : {cc['misses']} ({cc['compile_ms']} ms compiling)")
        if cc.get("rejected"):
            lines.append(f"    rejected entries  : {cc['rejected']} (stale/poisoned, healed)")
        for b in cc.get("bucket_compiles", []):
            lines.append(
                f"    bucket {b.get('program')}[{b.get('bucket')}]: built in {b.get('compile_ms')} ms"
            )
    traces = report.get("traces")
    if traces:
        lines.append("  traces:")
        lines.append(
            f"    requests          : {traces['count']} traced, {traces['completed']} completed ok"
        )
        if traces.get("by_class"):
            lines.append("    segment         count   p50_ms    p95_ms    total_ms  share")
            for name, row in traces["by_class"].items():
                lines.append(
                    f"    {name:<15} {row['count']:>5} {row['p50_ms']:>9.3f} {row['p95_ms']:>9.3f}"
                    f" {row['total_ms']:>11.3f}  {row['share']:.1%}"
                )
        for d in traces.get("drift_events", []):
            lines.append(
                f"    DRIFT: {d['segment']} vs {d['check']}: observed {d['observed']} "
                f"vs predicted {d['predicted']} ({d['rel_error']:.0%} off, trace {d['trace']})"
            )
        if traces.get("flight_dumps"):
            lines.append(f"    flight dumps      : {traces['flight_dumps']}")
    nf = report.get("nonfinite")
    if nf:
        lines.append("  non-finite watchdog:")
        for e in nf.get("events", []):
            lines.append(
                f"    NONFINITE at step {e.get('step')}: first bad leaf "
                f"{e.get('leaf')!r} = {e.get('value')}"
                + (f" (loss scale {e.get('loss_scale')})" if e.get("loss_scale") is not None else "")
            )
        if not nf.get("events"):
            lines.append("    all probes finite")
        ls = nf.get("loss_scale")
        if ls:
            lines.append(
                f"    loss scale        : {ls.get('current')} "
                f"(min {ls.get('min')}, max {ls.get('max')}, {ls.get('backoffs')} backoffs)"
            )
    if len(lines) == 1:
        lines.append("  (no step/hbm/serving records found)")
    return "\n".join(lines)
