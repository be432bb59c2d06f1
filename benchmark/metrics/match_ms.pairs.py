"""The harness's host clock around ``FeaturesDev.match``, per matched
pair: it returns numpy arrays, so it has waited for the card."""


def read(run):
    t = [r.match_s for r in run.window.requests if r.match_s is not None]
    return 1e3 * sum(t) / len(t) if t else None
