"""Share of the traced window in which no kernel, copy or set ran on the
card (torch.profiler's device activity)."""


def read(t):
    if t.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.device.busy_s / t.device.window_s)
