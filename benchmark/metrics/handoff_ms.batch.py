"""The worker's time outside the extraction, per image: the span window
(the pipe empty at both ends) less the sum of the program's ``extract``
host spans, over the images extracted (upload, queue and hand-off)."""


def read(run):
    if not run.spans or "extract" not in run.spans:
        return None
    n, total_ms = run.spans["extract"]
    return (1e3 * run.span_s - total_ms) / n
