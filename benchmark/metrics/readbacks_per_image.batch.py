"""The count of the program's ``readback.<site>`` host spans inside the
extraction (every site but the matcher's ``readback.match``), one a
synchronisation with the card, per image extracted."""


def read(run):
    if not run.spans or "extract" not in run.spans:
        return None
    counts = [v[0] for k, v in run.spans.items()
              if k.startswith("readback.") and k != "readback.match"]
    if not counts:
        return None
    return sum(counts) / run.spans["extract"][0]
