"""Step timeline: wall-time split, compile attribution, and the recompile
watchdog.

Counterpart of :mod:`accelerate_tpu.telemetry.step`. A ``step(batch)`` call
on the card is three costs on one wall clock: the host waiting for data,
the Python that enqueues the step's kernels, and the card running them
after the call returns. ``StepTelemetry`` fences with
``torch.cuda.synchronize`` (where the JAX package calls
``block_until_ready`` on the outputs) when the outputs hold a CUDA
tensor, so the three separate:

* ``data_wait_ms`` -- from the previous step's fence to this call;
* ``dispatch_ms``  -- inside the wrapped call (the whole step where the
  host waits on the card inside it, as a loss read back does);
* ``execute_ms``   -- blocked in the fence after the call returned.

The first call through a wrapper is attributed as compile time (eager
PyTorch compiles nothing, but the first step pays the allocator's and the
kernels' first-use costs), as is any call the watchdog flags.

The **recompile watchdog** keeps the JAX event: after ``warmup_steps``
calls, an input signature (structure + dtype and shape of each leaf) never
seen before emits ONE ``recompile`` warning naming what changed; a shape
seen before stays silent. Eager PyTorch has no compile cache to
cross-check, so the JAX ``_cache_size`` probe has no counterpart here: the
signature is the whole check.

The **perf-model drift check** compares the observed steady busy time with
a static prediction when one is attached (:meth:`StepTelemetry.
set_static_step_estimate`) and fires ONE ``perf_model_drift`` warning past
the threshold.

Per-step records are kept in a bounded deque (``summary()`` works with no
event log) and mirrored to an :class:`EventLog` when one is attached.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Optional

from .eventlog import EventLog


def _aval_str(leaf) -> str:
    """``float32[8,128]``-style signature for one leaf (a torch dtype in
    numpy's spelling, as the JAX package writes it)."""
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is not None and dtype is not None:
        return f"{str(dtype).removeprefix('torch.')}[{','.join(str(d) for d in shape)}]"
    return type(leaf).__name__


def signature_of(tree) -> tuple:
    """Hashable ``(path, dtype[shape])`` signature of an input tree, the
    host-side stand-in for a compile cache key. Dicts go by sorted key,
    lists and tuples by index, and a path reads ``0/0/input_ids``: the JAX
    package's spelling, so the two packages' watchdog events name inputs
    alike."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}" if path else str(i))
        else:
            out.append((path, _aval_str(node)))

    walk(tree, "")
    return tuple(out)


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


_AVAL_RE = None  # compiled lazily (re import kept off the hot path)


def suggest_buckets(old: Optional[tuple], new: tuple) -> list[str]:
    """Pad-shape suggestions that would have avoided a watchdog miss: for
    each input whose shape drifted between two signatures, the shape with
    every drifting dim padded to the next power of two covering both
    sides (what the JAX package's shape bucketer does). Dtype and rank
    changes yield no suggestion (padding can't fix those)."""
    global _AVAL_RE
    if not old or not new:
        return []
    if _AVAL_RE is None:
        import re

        _AVAL_RE = re.compile(r"^([A-Za-z0-9_]+)\[([0-9,]*)\]$")
    out = []
    old_map = dict(old)
    for path, aval in new:
        prev = old_map.get(path)
        if prev is None or prev == aval:
            continue
        m_new, m_old = _AVAL_RE.match(aval), _AVAL_RE.match(prev)
        if not m_new or not m_old or m_new.group(1) != m_old.group(1):
            continue  # dtype changed (or unparseable): not a padding problem
        nd = [int(d) for d in m_new.group(2).split(",") if d]
        od = [int(d) for d in m_old.group(2).split(",") if d]
        if len(nd) != len(od):
            continue  # rank changed
        padded = [n if n == o else _next_pow2(max(n, o)) for n, o in zip(nd, od)]
        if padded == nd:
            continue  # already at the covering size
        out.append(f"{path}: pad to {m_new.group(1)}[{','.join(str(d) for d in padded)}]")
    return out


def diff_signatures(old: Optional[tuple], new: tuple) -> list[str]:
    """Human strings naming what changed between two input signatures."""
    if old is None:
        return [f"{path}: {aval} (new input)" for path, aval in new]
    old_map, new_map = dict(old), dict(new)
    changes = []
    for path, aval in new:
        prev = old_map.get(path)
        if prev is None:
            changes.append(f"{path}: (absent) -> {aval}")
        elif prev != aval:
            changes.append(f"{path}: {prev} -> {aval}")
    for path, aval in old:
        if path not in new_map:
            changes.append(f"{path}: {aval} -> (absent)")
    return changes or ["input signature unchanged"]


def _block_until_ready(out):
    """Wait for the card when ``out`` holds a CUDA tensor (CPU tensors and
    other leaves need no fence)."""
    import torch

    from ..utils.operations import _leaves

    for leaf in _leaves(out):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


class StepTelemetry:
    """Timeline + watchdog for a repeatedly-called step function.

    Two usage shapes::

        st = StepTelemetry(log)
        step = st.wrap(step)          # fast path: instruments every call
        ...
        with st.step() as s:          # imperative path (accumulate block)
            loss = accelerator.backward(loss_fn, batch)
            s.done(loss)              # optional: what to fence on

    ``flops_per_step`` + ``peak_flops_per_device`` (+ ``n_devices``) turn
    each steady-state record into an MFU sample. ``fence=False`` drops the
    ``torch.cuda.synchronize`` (execute time then reads 0: use when the
    loop already waits, e.g. a ``float(loss)`` per step).

    ``warmup_steps`` defaults to 2, as in the JAX package: both warm-up
    calls are attributed as compiles and learn their signatures silently.
    """

    def __init__(
        self,
        log: Optional[EventLog] = None,
        *,
        warmup_steps: int = 2,
        fence: bool = True,
        watchdog: bool = True,
        flops_per_step: Optional[float] = None,
        peak_flops_per_device: Optional[float] = None,
        n_devices: int = 1,
        max_records: int = 4096,
        clock=time.perf_counter,
    ):
        self.log = log if log is not None else EventLog(None)
        self.warmup_steps = max(0, int(warmup_steps))
        self.fence = fence
        self.watchdog = watchdog
        self.flops_per_step = flops_per_step
        self.peak_flops_per_device = peak_flops_per_device
        self.n_devices = max(1, int(n_devices))
        self._clock = clock

        self.step_index = 0
        self.recompiles = 0
        self.compile_ms = 0.0  # summed over first step + every detected miss
        self.records: collections.deque = collections.deque(maxlen=max_records)
        self.recompile_events: list[dict] = []
        # perf-model drift check (seeded by set_static_step_estimate)
        self.static_step_ms: Optional[float] = None
        self.perf_drift_threshold = 0.5
        self.perf_drift_min_steady = 5
        self.perf_drift_event: Optional[dict] = None
        self._last_fence_end: Optional[float] = None
        self._cm_watchdog: Optional[_WatchdogState] = None  # context-manager path's
        self.on_step: Optional[Callable[[dict], None]] = None  # post-record hook

    # ------------------------------------------------------------------ #
    # instrumentation
    # ------------------------------------------------------------------ #

    def wrap(self, step_fn: Callable, *, name: str = "step") -> Callable:
        """Instrumented twin of ``step_fn``; every call records one step.
        The telemetry object rides on the wrapper as ``.telemetry``.

        Watchdog state (warmup counter, seen signatures) is per wrapper: a
        second wrapped function, or one wrapped after imperative steps
        already ran, gets its own warmup."""
        wd = _WatchdogState(self.warmup_steps)

        def instrumented(*args, **kwargs):
            sig = signature_of((args, kwargs)) if self.watchdog else None
            t_enter = self._clock()
            out = step_fn(*args, **kwargs)
            t_done = self._clock()
            if self.fence:
                _block_until_ready(out)
            t_fence = self._clock()
            self._record(name, sig, t_enter, t_done, t_fence, wd)
            return out

        instrumented.telemetry = self
        instrumented.__wrapped__ = step_fn
        return instrumented

    @contextlib.contextmanager
    def step(self, batch=None, *, name: str = "step"):
        """Context-manager form for imperative loops. ``batch`` (optional)
        feeds the watchdog; call ``handle.done(outputs)`` to mark dispatch
        complete and name what to fence on — otherwise the whole body
        counts as dispatch and the fence is skipped."""
        sig = signature_of(batch) if (self.watchdog and batch is not None) else None
        if self._cm_watchdog is None:
            self._cm_watchdog = _WatchdogState(self.warmup_steps)
        handle = _StepHandle(self._clock)
        t_enter = self._clock()
        yield handle
        t_done = handle.done_at if handle.done_at is not None else self._clock()
        if self.fence and handle.outputs is not None:
            _block_until_ready(handle.outputs)
        t_fence = self._clock()
        self._record(name, sig, t_enter, t_done, t_fence, self._cm_watchdog)

    # ------------------------------------------------------------------ #
    # internals
    # ------------------------------------------------------------------ #

    def _check_watchdog(self, wd: "_WatchdogState", sig) -> tuple[bool, list[str], bool]:
        """(is_miss, changed-aval strings, compile_hint) for this call
        through the wrapper owning ``wd``. During warmup every signature
        is learned silently, a fresh one still flagging the step as a
        compile step (keeping the steady-state stats clean); afterwards a
        never-seen signature is a miss."""
        if not self.watchdog:
            return False, [], False
        in_warmup = wd.calls < wd.warmup
        if sig is not None:
            fresh = sig not in wd.seen
            wd.seen.add(sig)
        else:
            fresh = False
        if in_warmup:
            return False, [], fresh
        if sig is not None and fresh:
            return True, diff_signatures(wd.last_sig, sig), True
        return False, [], False

    def _record(self, name, sig, t_enter, t_done, t_fence, wd: "_WatchdogState"):
        data_wait_ms = 0.0
        if self._last_fence_end is not None:
            data_wait_ms = max(0.0, (t_enter - self._last_fence_end) * 1000.0)
        dispatch_ms = (t_done - t_enter) * 1000.0
        execute_ms = (t_fence - t_done) * 1000.0
        self._last_fence_end = t_fence

        is_first = wd.calls == 0  # first call THROUGH THIS WRAPPER compiles
        miss, changed, compiled_hint = self._check_watchdog(wd, sig)
        if miss:
            self.recompiles += 1
            ev = self.log.event(
                "recompile",
                severity="warning",
                step=self.step_index,
                changed=changed,
                # the pad shape that would have avoided this miss (empty
                # when padding can't fix it — dtype/rank/structure drift)
                suggested_bucket=suggest_buckets(wd.last_sig, sig) if sig else [],
                count=self.recompiles,
            )
            self.recompile_events.append(ev)
        is_compile = is_first or miss or compiled_hint
        if is_compile:
            # on a miss/first call the dispatch segment IS the compile
            self.compile_ms += dispatch_ms

        rec = {
            "step": self.step_index,
            "dur_ms": round(data_wait_ms + dispatch_ms + execute_ms, 3),
            "data_wait_ms": round(data_wait_ms, 3),
            "dispatch_ms": round(dispatch_ms, 3),
            "execute_ms": round(execute_ms, 3),
            "compile": is_compile,
        }
        if (
            not is_compile
            and self.flops_per_step
            and self.peak_flops_per_device
            and (dispatch_ms + execute_ms) > 0
        ):
            step_s = (dispatch_ms + execute_ms) / 1000.0
            rec["mfu"] = round(
                self.flops_per_step / step_s / (self.peak_flops_per_device * self.n_devices), 5
            )
        self.log.emit("span", name, **rec)
        self.records.append(rec)
        if sig is not None:
            wd.last_sig = sig
        wd.calls += 1
        self.step_index += 1
        self._check_perf_drift()
        if self.on_step is not None:
            self.on_step(rec)

    # ------------------------------------------------------------------ #
    # perf-model drift (static roofline vs observed step split)
    # ------------------------------------------------------------------ #

    def set_static_step_estimate(self, predicted_ms: float, *, threshold: Optional[float] = None):
        """Attach a static step-time prediction (the JAX package's
        ``perf_check`` seeds it; the port's is ROADMAP.md Queue 1 item 11,
        so a caller passes its own). Once
        ``perf_drift_min_steady`` steady records exist, the observed
        median busy time (dispatch + execute — the part the roofline
        models; data-wait is the loader's problem) is compared against it
        and ONE ``perf_model_drift`` warning fires past ``threshold``."""
        self.static_step_ms = float(predicted_ms)
        if threshold is not None:
            self.perf_drift_threshold = float(threshold)
        self.perf_drift_event = None  # a new estimate re-arms the check
        self.log.event("perf_static_estimate", predicted_ms=round(self.static_step_ms, 4))

    def observed_busy_ms(self) -> Optional[float]:
        """Median steady-state dispatch+execute ms (None before any
        steady record)."""
        steady = self.steady_records()
        if not steady:
            return None
        busy = sorted(r["dispatch_ms"] + r["execute_ms"] for r in steady)
        return round(busy[len(busy) // 2], 3)

    def _check_perf_drift(self):
        if self.perf_drift_event is not None or not self.static_step_ms:
            return
        steady = self.steady_records()
        if len(steady) < self.perf_drift_min_steady:
            return
        observed = self.observed_busy_ms()
        if not observed:
            return
        rel = abs(observed - self.static_step_ms) / self.static_step_ms
        if rel > self.perf_drift_threshold:
            self.perf_drift_event = self.log.event(
                "perf_model_drift",
                severity="warning",
                predicted_ms=round(self.static_step_ms, 4),
                observed_busy_ms=observed,
                rel_error=round(rel, 4),
                threshold=self.perf_drift_threshold,
            )

    # ------------------------------------------------------------------ #
    # summaries
    # ------------------------------------------------------------------ #

    def steady_records(self) -> list[dict]:
        return [r for r in self.records if not r["compile"]]

    def summary(self) -> dict:
        """p50/p95 step split, compile attribution, recompiles, MFU and
        goodput over the retained (steady-state) records."""
        steady = self.steady_records()
        durs = sorted(r["dur_ms"] for r in steady)
        out = {
            "steps": self.step_index,
            "steady_steps": len(steady),
            "compile_ms": round(self.compile_ms, 3),
            "recompiles": self.recompiles,
            "p50_step_ms": _pct(durs, 50),
            "p95_step_ms": _pct(durs, 95),
        }
        if steady:
            total = sum(r["dur_ms"] for r in steady)
            out["mean_data_wait_ms"] = round(sum(r["data_wait_ms"] for r in steady) / len(steady), 3)
            out["mean_dispatch_ms"] = round(sum(r["dispatch_ms"] for r in steady) / len(steady), 3)
            out["mean_execute_ms"] = round(sum(r["execute_ms"] for r in steady) / len(steady), 3)
            # goodput: fraction of steady wall time the device spent executing
            # (dispatch included when unfenced loops fold execute into it)
            busy = sum(r["dispatch_ms"] + r["execute_ms"] for r in steady)
            out["goodput"] = round(min(1.0, busy / total), 4) if total > 0 else None
            mfus = [r["mfu"] for r in steady if "mfu" in r]
            if mfus:
                out["mfu"] = round(sum(mfus) / len(mfus), 5)
        if self.static_step_ms:
            out["static_step_ms"] = round(self.static_step_ms, 4)
            observed = self.observed_busy_ms()
            if observed is not None:
                out["observed_busy_ms"] = observed
            out["perf_model_drift"] = self.perf_drift_event is not None
        return out


class _WatchdogState:
    """Per-wrapper watchdog bookkeeping: warmup counter, seen input
    signatures, last signature (for diff naming). One per
    :meth:`StepTelemetry.wrap` call (and one shared by the context-manager
    path): warmup belongs to a step function, not to the run."""

    __slots__ = ("warmup", "calls", "seen", "last_sig")

    def __init__(self, warmup: int):
        self.warmup = warmup
        self.calls = 0
        self.seen: set = set()
        self.last_sig: Optional[tuple] = None


class _StepHandle:
    """Yielded by :meth:`StepTelemetry.step`; ``done(outputs)`` marks the
    dispatch boundary and registers what the exit fence blocks on."""

    def __init__(self, clock):
        self._clock = clock
        self.outputs = None
        self.done_at: Optional[float] = None

    def done(self, outputs=None):
        self.done_at = self._clock()
        self.outputs = outputs
        return outputs


def _pct(sorted_vals: list, q: float) -> Optional[float]:
    """Nearest-rank percentile (no numpy needed at summarize time)."""
    if not sorted_vals:
        return None
    k = max(0, min(len(sorted_vals) - 1, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return round(sorted_vals[k], 3)
