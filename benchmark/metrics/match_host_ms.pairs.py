"""The mean of the program's ``match`` host spans, one per matched pair:
``FeaturesDev.match``, its five copies to the host included."""


def read(run):
    if not run.spans or "match" not in run.spans:
        return None
    n, total_ms = run.spans["match"]
    return total_ms / n
