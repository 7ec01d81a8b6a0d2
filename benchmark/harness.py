"""One run of one cell: set-up, warm-up, the measured window, the traced
readings and the correctness check, reduced to the result line."""

from __future__ import annotations

import math
import subprocess
import sys
import time
from typing import NamedTuple

import torch

from benchmark import check, spec, system, trace as trace_mod, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "rigid_body_light_tpu")
WARM_STEPS = 2
# a traced run's device trace covers its window's last chunks from this
# many seconds before the window's end: the profiler's trace of a longer
# stretch takes minutes to read
TRACE_SECONDS = 10.0


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``rigid_body_light_tpu_torch`` is not ``rigid_body_light_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Marks:
    """Marks on the device's timeline (CUDA events), or the host clock."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self):
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


class TraceView(NamedTuple):
    """What a per-layer metric's reader reads."""
    steps: int
    iters: int            # GMRES iterations over the window
    chunk_iters: list     # GMRES iterations a step, per chunk of the window
    split: dict           # the port's StepTimer split of the window
    device: object        # trace.DeviceTrace
    positions: object     # (N, 3) float32 blob positions at the window's end
    sim: dict             # the cell's settings


class Window(NamedTuple):
    state: object
    steps: int
    failed: list          # per step: the solve failed
    iters: int
    chunk_iters: list
    step_ms: list         # per step, on the device's timeline
    seconds: float
    split: dict
    prof: object


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_line():
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def window(sysm, seed, seconds, device, traced) -> Window:
    """Chunks of ``run_bd`` as the port's runner runs them (each chunk's
    frames copied to the host, its final state the next chunk's start)
    until ``seconds`` have passed; a mark on the device's timeline at each
    step's start and one after the last chunk.  Traced: the StepTimer over
    the whole window, the profiler over its last chunks: from the chunk
    that, as long as the one before it, ends past ``seconds -
    TRACE_SECONDS``."""
    from rigid_body_light_tpu_torch.utils import profiling

    gen = torch.Generator(device=device).manual_seed(
        traffic.stream(seed, traffic.DRAWS))
    marks = Marks(device)

    def timed_force(s, i):
        marks.mark()
        return sysm.force_fn(s, i)

    timer = prof = None
    if traced:
        timer = profiling.StepTimer(device)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        timer.__enter__()
    state, steps, residual, iters, chunk_iters = sysm.state, 0, [], 0, []
    profiling_on, chunk_s = False, 0.0
    t0 = time.perf_counter()
    try:
        while True:
            t_chunk = time.perf_counter()
            # on from the chunk that is to end past seconds - TRACE_SECONDS
            if traced and not profiling_on and \
                    t_chunk + chunk_s - t0 >= seconds - TRACE_SECONDS:
                prof.__enter__()
                profiling_on = True
            state, traj = system.run_chunk(sysm, state, sysm.chunk, gen,
                                           timed_force)
            traj["X"].cpu().numpy(), traj["Q"].cpu().numpy()   # the frames
            residual.append(traj["residual"].cpu())
            chunk_iters.append(float(traj["iters"].double().mean()))
            iters += int(traj["iters"].sum())
            steps += sysm.chunk
            chunk_s = time.perf_counter() - t_chunk
            print(f"chunk {len(residual)}: {steps} steps at "
                  f"{time.perf_counter() - t0:.3f} s, GMRES iterations "
                  f"{chunk_iters[-1]:.2f} a step", file=sys.stderr,
                  flush=True)
            if time.perf_counter() - t0 >= seconds:
                break
        marks.mark()
        _sync(device)
        t1 = time.perf_counter()
    finally:
        if traced:
            if profiling_on:
                prof.__exit__(None, None, None)
            timer.__exit__(None, None, None)
            print(f"trace: profiler stopped {time.perf_counter() - t0:.3f} s "
                  "after the window's start", file=sys.stderr, flush=True)
    res = torch.cat(residual)
    failed = (~(res < sysm.cfg.max_step_residual)).tolist()
    return Window(state, steps, failed, iters, chunk_iters,
                  marks.intervals_ms(), t1 - t0,
                  timer.split() if traced else {},
                  prof if profiling_on else None)


def _p90(values):
    s = sorted(values)
    return s[max(0, math.ceil(0.9 * len(s)) - 1)]


def run_cell(cell, seed, seconds, traced, device, t_process):
    """The result line's dict of one run of ``cell`` (see README.md)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sysm = system.build(cell, seed, device)
    warm = torch.Generator(device=device).manual_seed(
        traffic.stream(seed, traffic.WARM))
    system.run_chunk(sysm, sysm.state, WARM_STEPS, warm, sysm.force_fn)
    _sync(device)
    setup_s = time.perf_counter() - t_process
    w = window(sysm, seed, seconds, device, traced)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    step_ms = [math.inf if f else ms for f, ms in zip(w.failed, w.step_ms)]
    e2e = {"steps_per_s": w.steps / w.seconds,
           "step_ms_p90": _p90(step_ms),
           "peak_mem_gib": peak / 2**30,
           "setup_s": setup_s}
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": 1, "memory_peak_bytes": peak}
    result = {"correct": None, "attempted": w.steps,
              "failed": int(sum(w.failed)), "metrics": {}, "device": dev_info}
    if traced:
        t_read = time.perf_counter()
        dt = trace_mod.reduce(w.prof)
        w = w._replace(prof=None)
        print(f"trace: read in {time.perf_counter() - t_read:.3f} s",
              file=sys.stderr, flush=True)
        view = TraceView(w.steps, w.iters, w.chunk_iters, w.split, dt,
                         system.positions(sysm, w.state), sysm.sim)
        for m in cell["per_layer"]:
            v = spec.reader(m["name"])(view)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info["busy_s"], dev_info["window_s"] = dt.busy_s, dt.window_s
        result["breakdown"] = {"device_ops": dt.device_ops,
                               "idle_gaps": dt.idle_gaps}
    else:
        for m in cell["end_to_end"]:
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}
    out, rows = outputs(cell, sysm, w.state, seed, device)
    numbers = check.judge(out, sysm.sim, sysm.shell, rows, device)
    ok, rows = check.verdict(numbers, cell["limits"]["limits"])
    result["correct"] = bool(ok)
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result


def outputs(cell, sysm, state, seed, device):
    """The program's outputs at the window's final state, with the
    program's caches freed after them, and the blobs the check samples."""
    gen = torch.Generator(device=device).manual_seed(
        traffic.stream(seed, traffic.CHECK))
    out = system.program_outputs(sysm, state, gen)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cpu_gen = torch.Generator().manual_seed(
        traffic.stream(seed, traffic.CHECK))
    n_blobs = sysm.shell[1].shape[0]
    k = min(out["X"].shape[0], int(cell["limits"]["sample_bodies"]))
    return out, check.sample_rows(out["X"].shape[0], n_blobs, k, cpu_gen)
