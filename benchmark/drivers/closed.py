"""Closed loop over single images: the caller keeps ``in_flight`` jobs
enqueued, waits for the oldest with ``SiftJob.get()`` (the host
features) and enqueues the next frame.  One in flight is a tracker that
waits for each frame; several are an offline extraction of a photo set
or a video."""

from __future__ import annotations

import collections
import math
import sys
import traceback

from ..lib.records import Request, Window, clock


def _send(ctx):
    i = ctx.next_index()
    img = ctx.gen.request(i)
    with ctx.scope("bench.enqueue"):
        req = Request(i, clock())
        job = ctx.ps.enqueue(img.shape[1], img.shape[0], img)
    return job, req


def _finish(ctx, job, req):
    feats = None
    with ctx.scope("bench.get"):
        try:
            feats = job.get() if job is not None else None
        except Exception:  # noqa: BLE001 - a failed request is counted
            traceback.print_exc(file=sys.stderr)
        req.t_done = clock()
    req.ok = feats is not None
    return feats


def run(ctx, count: int | None = None, seconds: float | None = None,
        sample=None) -> Window:
    """Send ``count`` requests, or as many as ``seconds`` allow, and wait
    for every one sent; ``sample`` (a Reservoir) is offered each output."""
    depth = int(ctx.traffic["in_flight"])
    win = Window(clock())
    end = win.t0 + seconds if seconds is not None else math.inf
    inflight = collections.deque()
    sent = 0
    while True:
        while (len(inflight) < depth and (count is None or sent < count)
               and clock() < end):
            inflight.append(_send(ctx))
            sent += 1
        if not inflight:
            break
        job, req = inflight.popleft()
        feats = _finish(ctx, job, req)
        win.requests.append(req)
        if sample is not None and req.ok:
            sample.offer(req.index, feats)
    win.t1 = end if seconds is not None else clock()
    return win
