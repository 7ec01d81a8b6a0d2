"""Tracing and metrics — the port of ``rigid_body_light_tpu/utils/
profiling.py``, with a per-part step timer.

- :func:`sync`, :func:`timed`, :class:`StepMetrics`: as in the JAX package;
  ``sync`` waits for the card (a CUDA synchronize) instead of forcing a
  host transfer.
- :func:`profiler_trace`: a ``torch.profiler`` trace (Chrome trace JSON)
  in place of the JAX package's ``jax.profiler`` trace.
- :class:`StepTimer`: named spans of the step's parts, timed by CUDA events
  on the card (by the host clock on the CPU).  The step's code marks its
  parts with :func:`span`, which does nothing unless a timer is active in
  the calling context (``with StepTimer() as timer:``), so the step runs
  untimed by default.  The parts (:data:`PARTS`) are the kernels (by their
  launch-count names), the mobility products around them, the GMRES loop,
  the Lanczos recurrence, the RFD drift, the preconditioner's build and
  applies, kinematics, the far field's lattice build and position setup,
  the balanced-split Ewald operator's tile sweep (``ewald_cells``), its
  sorted tiles and neighbor lists (``ewald_tiles``) and gridded wave part,
  and, on the distributed path, the collectives (``collective``: the
  all-reduces, gathers and ring transfers of
  :mod:`rigid_body_light_tpu_torch.utils.collectives`).  A span's time runs from the card reaching its start to the card
  reaching its end, so it holds the card's idle time while the host works
  inside it; :meth:`StepTimer.split` subtracts the spans nested in a span
  to give each part's own time.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import os
import time
from typing import Optional

import torch

from rigid_body_light_tpu_torch.state import resolve_device

logger = logging.getLogger("rigid_body_light_tpu_torch")

# the parts the step marks, outermost first
PARTS = ("step", "noise", "rfd", "kinematics", "pc_build", "gmres",
         "pc_apply", "mobility", "lattice_build", "far_setup", "far_band",
         "ewald_cells", "ewald_tiles", "ewald_pme", "collective",
         "pair_sweep_sym", "pair_sweep_ordered", "near_sweep",
         "near_sweep_slice", "ewald_real_sweep", "ewald_real_tiles")

_ACTIVE = contextvars.ContextVar("rigid_body_light_tpu_torch_step_timer",
                                 default=None)
_OFF = contextlib.nullcontext()


def sync(x) -> float:
    """Wait for the device and reduce ``x`` to a host scalar."""
    return float(torch.as_tensor(x).sum().item())


@contextlib.contextmanager
def timed(label: str, result_holder: Optional[dict] = None):
    """Wall-clock a block; the caller syncs device work inside the block."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if result_holder is not None:
        result_holder[label] = dt
    logger.info("%s: %.4f s", label, dt)


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the CPU and, where there is one,
    the card; written to ``log_dir/trace.json`` (Chrome trace format).
    Yields the profiler, whose ``key_averages()`` sums time by kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepMetrics:
    """Accumulates per-step metrics; emits one JSON line per step."""

    def __init__(self):
        self.steps = []

    def record(self, step: int, wall_time: float, residual: float, **extra):
        row = {"step": step, "wall_time_s": wall_time,
               "gmres_residual": residual}
        row.update(extra)
        self.steps.append(row)
        logger.info("%s", json.dumps(row))

    @property
    def steps_per_sec(self) -> float:
        if not self.steps:
            return 0.0
        total = sum(r["wall_time_s"] for r in self.steps)
        return len(self.steps) / total if total > 0 else 0.0


def span(name: str):
    """A context that times the part ``name`` in the active
    :class:`StepTimer`, or does nothing when no timer is active."""
    timer = _ACTIVE.get()
    return _OFF if timer is None else timer.span(name)


class StepTimer:
    """Named, nested spans of a run, timed on ``device``'s timeline.

    ``with StepTimer() as timer: run_bd(...)`` then ``timer.split()``.  On
    the card each span records two CUDA events on the current stream; on
    the CPU it reads the host clock.  Scripts use it; the step never turns
    it on by itself.
    """

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._spans = []     # [name, parent index, start, end]
        self._stack = []
        self._token = None

    def __enter__(self):
        self._token = _ACTIVE.set(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.reset(self._token)
        self._token = None
        return False

    def _mark(self):
        if not self._cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _ms(self, start, end):
        if not self._cuda:
            return (end - start) * 1e3
        return start.elapsed_time(end)

    @contextlib.contextmanager
    def span(self, name: str):
        parent = self._stack[-1] if self._stack else -1
        rec = [name, parent, self._mark(), None]
        self._spans.append(rec)
        self._stack.append(len(self._spans) - 1)
        try:
            yield
        finally:
            self._stack.pop()
            rec[3] = self._mark()

    def split(self) -> dict:
        """{part: {"ms": time inside its spans, "self_ms": less the spans
        nested in them, "count": spans}}, in milliseconds summed over the
        run.  Waits for the device."""
        if self._stack:
            raise RuntimeError("StepTimer.split inside an open span")
        if self._cuda:
            torch.cuda.synchronize(self.device)
        total = [self._ms(s[2], s[3]) for s in self._spans]
        nested = [0.0] * len(total)
        for i, s in enumerate(self._spans):
            if s[1] >= 0:
                nested[s[1]] += total[i]
        out = {}
        for i, s in enumerate(self._spans):
            part = out.setdefault(s[0], {"ms": 0.0, "self_ms": 0.0,
                                         "count": 0})
            part["ms"] += total[i]
            part["self_ms"] += total[i] - nested[i]
            part["count"] += 1
        return out
