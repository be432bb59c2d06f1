"""The mean of the program's ``extract`` host spans, per image."""


def read(run):
    if not run.spans or "extract" not in run.spans:
        return None
    n, total_ms = run.spans["extract"]
    return total_ms / n
