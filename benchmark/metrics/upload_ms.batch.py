"""The mean of the program's ``upload`` host spans: the H2D copy of a
job's image from pageable memory."""


def read(run):
    if not run.spans or "upload" not in run.spans:
        return None
    n, total_ms = run.spans["upload"]
    return total_ms / n
