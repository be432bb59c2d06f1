"""The program's ``stage1.o<k>`` host spans (pyramid, detection and
refinement of each octave) summed, per image extracted."""

import re


def read(run):
    if not run.spans or "extract" not in run.spans:
        return None
    total = sum(v[1] for k, v in run.spans.items()
                if re.fullmatch(r"stage1\.o\d+", k))
    return total / run.spans["extract"][0]
