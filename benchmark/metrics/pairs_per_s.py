"""Pairs whose match (or, with no descriptor on a side, whose second
``get_dev()``) returned inside the window, over the window's length."""


def read(run):
    w = run.window
    return len(w.done_in_window()) / w.seconds
