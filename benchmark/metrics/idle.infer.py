"""``idle.infer``: the share of the measured window in which no operation
ran on the device (1 - the union of the kernel, copy and fill intervals
over the window), in percent."""


def read(trace, run):
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
