"""Operator B's milliseconds a refinement iteration over the window: the
thread-seconds inside the refinements (``refine_s``) over their gradient
iterations (``refine_iters``), from ``SeriesResult.feeds``."""


def read(ctx):
    feeds = ctx["result"].feeds
    iters = sum(f.get("refine_iters", 0) for f in feeds)
    if not iters:
        return None
    return 1e3 * sum(f["refine_s"] for f in feeds) / iters
