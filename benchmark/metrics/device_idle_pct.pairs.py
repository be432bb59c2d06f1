"""The device's idle share of the traced slice: 1 less the union of its
kernels, copies and sets over the slice's length, in %."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
