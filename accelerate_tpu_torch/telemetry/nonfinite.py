"""Non-finite watchdog: catches the fp16 and fp8 runs that overflow.

Counterpart of :mod:`accelerate_tpu.telemetry.nonfinite`. Every ``every``
steps it probes the loss, the gradient norm and (optionally) a gradient
tree for NaN/inf, and tracks the fp16 dynamic loss-scale trajectory. The
first non-finite value latches ONE ``nonfinite`` event naming the first
bad leaf (a diverged run floods every later step; one event with the
first culprit is what you debug from). Loss-scale changes land as
``loss_scale`` events, so the backoff staircase before an overflow is on
the same timeline.

Opt-in (a probe is a host sync): ``TelemetryKwargs(nonfinite_every=N)``
and the train step probes itself, or by hand::

    wd = telemetry.nonfinite
    wd.observe(step, loss=loss, grad_norm=gnorm, loss_scale=scale)
"""

from __future__ import annotations

import math
from typing import Any, Optional

from .eventlog import EventLog


def _paths(tree, prefix=""):
    """``(path, leaf)`` pairs in the JAX package's key order and spelling
    (dict keys sorted, ``['key']`` and ``[index]``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _tree_first_nonfinite(tree) -> Optional[str]:
    """Path of the first non-finite leaf of a tree of tensors or arrays,
    or None. A tensor is checked where it lives (only the verdict crosses
    to the host); one sync a floating leaf checked."""
    import numpy as np
    import torch

    for path, leaf in _paths(tree):
        if isinstance(leaf, torch.Tensor):
            if (leaf.is_floating_point() or leaf.is_complex()) and not bool(torch.isfinite(leaf).all()):
                return path
            continue
        try:
            arr = np.asarray(leaf, dtype=np.float64)
        except (TypeError, ValueError):
            continue
        if not np.isfinite(arr).all():
            return path
    return None


def _scalar(value) -> Optional[float]:
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


class NonFiniteWatchdog:
    """Every-N-steps finiteness probe on loss / grad-norm / gradients,
    plus the fp16 loss-scale trajectory. Fires ONE latched ``nonfinite``
    event naming the first bad leaf."""

    def __init__(self, log: Optional[EventLog] = None, *, every: int = 0, max_trajectory: int = 256):
        self.log = log if log is not None else EventLog(None)
        self.every = max(0, int(every))
        self.probes = 0
        self.nonfinite_event: Optional[dict] = None
        #: non-finite grads the fp16 scaler already handled (skipped step
        #: + backoff) — counted, never latched
        self.scaler_skips = 0
        #: (step, scale) pairs, recorded on change only
        self.scale_trajectory: list[tuple[int, float]] = []
        self.scale_backoffs = 0
        self._max_trajectory = max(2, int(max_trajectory))
        self._last_scale: Optional[float] = None

    @property
    def enabled(self) -> bool:
        return self.every > 0

    def observe(
        self,
        step: int,
        *,
        loss: Any = None,
        grad_norm: Any = None,
        grads: Any = None,
        loss_scale: Any = None,
        scaler_handled: bool = False,
        force: bool = False,
    ) -> Optional[dict]:
        """Probe at the configured cadence (``force=True`` probes
        regardless). Values may be device arrays — they are only coerced
        (synced) on probe steps. ``scaler_handled=True`` means a dynamic
        loss scaler owns grad overflow on this step (it skips the update
        and backs off): non-finite *gradients* then count as
        ``scaler_skips`` instead of latching — that is the scaler doing
        its job, and the backoff staircase is already in the trajectory.
        A non-finite **loss** always latches. Returns the probe record,
        or None when this step is off-cadence."""
        if not force and (self.every <= 0 or step % self.every != 0):
            return None
        self.probes += 1
        bad_leaf = None
        bad_value = None

        scale = _scalar(loss_scale)
        if scale is not None and scale != self._last_scale:
            if self._last_scale is not None and scale < self._last_scale:
                self.scale_backoffs += 1
            self._last_scale = scale
            self.scale_trajectory.append((int(step), scale))
            del self.scale_trajectory[: -self._max_trajectory]
            self.log.event("loss_scale", step=int(step), scale=scale, backoffs=self.scale_backoffs)

        for name, value in (("loss", loss), ("grad_norm", grad_norm)):
            v = _scalar(value)
            if v is not None and not math.isfinite(v):
                bad_leaf, bad_value = name, v
                break
        if bad_leaf is None and grads is not None:
            path = _tree_first_nonfinite(grads)
            if path is not None:
                bad_leaf = f"grads{path}"

        record = {"step": int(step), "bad_leaf": bad_leaf}
        if bad_leaf is not None and bad_leaf != "loss" and scaler_handled:
            self.scaler_skips += 1
            self.log.event("nonfinite_skipped", step=int(step), leaf=bad_leaf, loss_scale=scale)
            record["scaler_handled"] = True
            return record
        if bad_leaf is not None and self.nonfinite_event is None:
            self.nonfinite_event = self.log.event(
                "nonfinite",
                severity="warning",
                step=int(step),
                leaf=bad_leaf,
                value=str(bad_value) if bad_value is not None else "nan/inf",
                loss_scale=scale,
                recent_loss_scales=[s for _, s in self.scale_trajectory[-8:]],
            )
        return record

    def summary(self) -> dict:
        out: dict = {
            "probes": self.probes,
            "nonfinite": self.nonfinite_event is not None,
            "scaler_skips": self.scaler_skips,
        }
        if self.nonfinite_event is not None:
            out["first_bad_leaf"] = self.nonfinite_event.get("leaf")
            out["nonfinite_step"] = self.nonfinite_event.get("step")
        if self.scale_trajectory:
            scales = [s for _, s in self.scale_trajectory]
            out["loss_scale"] = {
                "current": scales[-1],
                "min": min(scales),
                "max": max(scales),
                "backoffs": self.scale_backoffs,
            }
        return out
