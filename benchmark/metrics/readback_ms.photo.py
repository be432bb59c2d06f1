"""The batch cells' ``readback_ms.batch``, read in the photograph cell (the
benchmark's tests keep that metric's declaration to the batch cells)."""

from benchmark.lib import spec


def read(run):
    return spec.reader("readback_ms.batch")(run)
