"""The reduction of a ``torch.profiler`` trace of the window: device time
by kernel, the device's busy time, and the idle gaps by what the host was
doing in them."""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import NamedTuple

GAPS_NAMED = 2000      # the longest idle gaps that get a host-side name
NAME_CHARS = 160       # a name in the breakdown is cut to this length
SCAN_BACK = 256        # host events looked at before a gap's middle


class DeviceTrace(NamedTuple):
    kernels: dict        # short kernel name → device seconds
    launches: dict       # short kernel name → launches
    busy_s: float        # seconds in which a kernel, copy or set ran
    window_s: float      # the traced window
    device_ops: list     # [[name, seconds]], the 10 longest in total
    idle_gaps: list      # [[host activity, seconds]], the 10 largest


def short_name(name: str) -> str:
    """A kernel's demangled name without ``void`` and its arguments."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out).strip()


def reduce(prof) -> DeviceTrace:
    """The reduction of ``prof`` (empty for None: nothing was traced)."""
    dev, host = [], []
    events = prof.profiler.kineto_results.events() if prof else []
    for e in events:
        span = (e.start_ns(), e.end_ns(), e.name())
        (dev if "CUDA" in str(e.device_type()) else host).append(span)
    if not dev:
        return DeviceTrace({}, {}, 0.0, 0.0, [], [])
    kernels, launches = defaultdict(float), defaultdict(int)
    for s, t, name in dev:
        k = short_name(name)
        kernels[k] += (t - s) * 1e-9
        launches[k] += 1
    dev.sort()
    lo = min(dev[0][0], min((h[0] for h in host), default=dev[0][0]))
    hi = max(max(d[1] for d in dev), max((h[1] for h in host), default=0))
    busy, gaps, cur_s, cur_t = 0, [], dev[0][0], dev[0][1]
    if dev[0][0] > lo:
        gaps.append((lo, dev[0][0]))
    for s, t, _ in dev[1:]:
        if s > cur_t:
            busy += cur_t - cur_s
            gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    busy += cur_t - cur_s
    if hi > cur_t:
        gaps.append((cur_t, hi))
    ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return DeviceTrace(dict(kernels), dict(launches), busy * 1e-9,
                       (hi - lo) * 1e-9,
                       [[k[:NAME_CHARS], v] for k, v in ops],
                       _name_gaps(gaps, host))


def _name_gaps(gaps, host):
    """The longest gaps, summed by the innermost host event at each gap's
    middle."""
    host.sort()
    starts = [h[0] for h in host]
    named = defaultdict(float)
    for s, t in sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_NAMED]:
        mid = (s + t) // 2
        i = bisect.bisect_right(starts, mid)
        best = None
        for hs, ht, name in host[max(0, i - SCAN_BACK):i]:
            if ht >= mid and (best is None or ht - hs < best[0]):
                best = (ht - hs, name)
        named[best[1] if best else "(host outside any op)"] += (t - s) * 1e-9
    return [[k[:NAME_CHARS], v]
            for k, v in sorted(named.items(), key=lambda kv: -kv[1])[:10]]
