"""The mean of the program's ``queue`` host spans: a job's wait from its
``enqueue`` to a worker taking it."""


def read(run):
    if not run.spans or "queue" not in run.spans:
        return None
    n, total_ms = run.spans["queue"]
    return total_ms / n
