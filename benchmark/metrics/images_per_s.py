"""Images whose ``get()`` returned inside the window, over the window's
length."""


def read(run):
    w = run.window
    return sum(r.images for r in w.done_in_window()) / w.seconds
