"""The program's ``stage2.o<k>`` host spans (orientation, descriptors
and download of each octave) summed, per image extracted."""

import re


def read(run):
    if not run.spans or "extract" not in run.spans:
        return None
    total = sum(v[1] for k, v in run.spans.items()
                if re.fullmatch(r"stage2\.o\d+", k))
    return total / run.spans["extract"][0]
