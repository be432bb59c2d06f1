"""The program's kernel launch counts (``kernels._lib.launches()``) over
the traced slice, which starts and ends with the pipe empty, per image."""


def read(run):
    if run.launches is None:
        return None
    return sum(run.launches.values()) / run.slice_requests
