"""The program's ``stage1.o<k>`` host spans (pyramid, detection and
refinement of each octave) summed, per image extracted; nothing where
the program records no such span."""

import re


def read(run):
    if not run.spans or "extract" not in run.spans:
        return None
    stage1 = [v[1] for k, v in run.spans.items()
              if re.fullmatch(r"stage1\.o\d+", k)]
    if not stage1:
        return None
    return sum(stage1) / run.spans["extract"][0]
