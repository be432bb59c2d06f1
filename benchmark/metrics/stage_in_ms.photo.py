"""The mean of the program's ``stage_in`` host spans: the caller's copy
of a job's image onto the card at ``enqueue``, band by band through the
page-locked ring, each band's DMA overlapping the copy of the next.  A
program without the ring records no such span, and the metric is left
out."""


def read(run):
    if not run.spans or "stage_in" not in run.spans:
        return None
    n, total_ms = run.spans["stage_in"]
    return total_ms / n
