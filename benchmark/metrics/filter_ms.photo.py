"""The program's ``filter`` host spans (the grid filter over every
octave's extrema, its recompaction's readbacks included), per image
extracted; nothing where the program records no such span."""


def read(run):
    if not run.spans or "filter" not in run.spans \
            or "extract" not in run.spans:
        return None
    return run.spans["filter"][1] / run.spans["extract"][0]
