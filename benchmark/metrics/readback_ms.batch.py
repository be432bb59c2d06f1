"""The program's ``readback.<site>`` host spans inside the extraction
(every site but the matcher's ``readback.match``), the host's waits for
the card, summed per image extracted."""


def read(run):
    if not run.spans or "extract" not in run.spans:
        return None
    waits = [v[1] for k, v in run.spans.items()
             if k.startswith("readback.") and k != "readback.match"]
    if not waits:
        return None
    return sum(waits) / run.spans["extract"][0]
