"""The program's ``extract`` host spans less their ``readback.<site>``
children (every readback site but the matcher's), per image extracted:
the host's time issuing work in the extraction."""


def read(run):
    if not run.spans or "extract" not in run.spans:
        return None
    waits = [v[1] for k, v in run.spans.items()
             if k.startswith("readback.") and k != "readback.match"]
    if not waits:
        return None
    n, total_ms = run.spans["extract"]
    return (total_ms - sum(waits)) / n
