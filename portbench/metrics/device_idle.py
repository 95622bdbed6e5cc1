"""Percent of the traced window's wall time in which no kernel, copy or
memset runs on the card: one minus the union of the device intervals over
the window. Reads `device_idle.serve` and `device_idle.train`."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
