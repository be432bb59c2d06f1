"""Closed loop over image pairs, one pair at a time, as a matching front
end runs MatchingMode: two ``enqueue``s, two ``get_dev()``s (descriptors
left on the card), then ``FeaturesDev.match`` with the traffic's ratio.
The next pair's images are made while the worker extracts.  A pair with
no descriptor on a side is not matched (the matcher takes no empty
side); its extractions still count."""

from __future__ import annotations

import math
import sys
import traceback

from ..lib.records import Request, Window, clock


def run(ctx, count: int | None = None, seconds: float | None = None,
        sample=None) -> Window:
    ratio = float(ctx.traffic["ratio"])
    win = Window(clock())
    end = win.t0 + seconds if seconds is not None else math.inf
    sent = 0
    i = ctx.next_index()
    a, b = ctx.gen.request(i)
    while (count is None or sent < count) and clock() < end:
        h, w = a.shape
        with ctx.scope("bench.enqueue"):
            req = Request(i, clock(), images=2)
            ja = ctx.ps.enqueue(w, h, a)
            jb = ctx.ps.enqueue(w, h, b)
        sent += 1
        i = ctx.next_index()
        a, b = ctx.gen.request(i)
        out = None
        try:
            with ctx.scope("bench.get"):
                fa, fb = ja.get_dev(), jb.get_dev()
            with ctx.scope("bench.match"):
                t = clock()
                m = (fa.match(fb, ratio) if fa.get_descriptor_count()
                     and fb.get_descriptor_count() else None)
                req.match_s = clock() - t if m is not None else None
            out = (fa, fb, m)
        except Exception:  # noqa: BLE001 - a failed request is counted
            traceback.print_exc(file=sys.stderr)
        req.t_done = clock()
        req.ok = out is not None and out[0] is not None \
            and out[1] is not None
        win.requests.append(req)
        if sample is not None and req.ok:
            sample.offer(req.index, out)
    win.t1 = end if seconds is not None else clock()
    return win


def warmup(ctx, count: int) -> Window:
    """Pairs until ``count`` of them went through the matcher (a pair of
    featureless images skips it), so that its first call, which sets up
    cuBLAS, comes before the window."""
    win = Window(clock())
    matched = 0
    while matched < count and len(win.requests) < 64:
        w = run(ctx, count=1)
        win.requests += w.requests
        matched += sum(r.match_s is not None for r in w.requests)
    win.t1 = clock()
    return win
