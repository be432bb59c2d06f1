"""The candidates and extrema that the octaves' capacities dropped, per
image extracted: the program's ``#stage1.overflow`` series (one value an
image); nothing where the program records no such series."""


def read(run):
    if not run.spans or "#stage1.overflow" not in run.spans \
            or "extract" not in run.spans:
        return None
    return run.spans["#stage1.overflow"][1] / run.spans["extract"][0]
