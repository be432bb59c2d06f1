"""Set-up: from the process's start to the first timed request (the
import, the CUDA context, the kernel library, the inputs, the warm-up)."""


def read(run):
    return run.setup_s
