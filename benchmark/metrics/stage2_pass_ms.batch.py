"""The program's ``stage2`` host span (the one pass of orientation,
descriptors and download over every octave) summed, per image
extracted."""


def read(run):
    if not run.spans or "extract" not in run.spans \
            or "stage2" not in run.spans:
        return None
    return run.spans["stage2"][1] / run.spans["extract"][0]
