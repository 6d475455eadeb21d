"""Operator B's gradient iterations a refinement over the window: the
feeds' ``refine_iters`` (one lane, so steps are iterations) over their
refinements, from ``SeriesResult.feeds``.  Nothing to read where nothing
refined (a composing session)."""


def read(ctx):
    feeds = ctx["result"].feeds
    refined = sum(f["refined"] for f in feeds)
    if not refined or any("refine_iters" not in f for f in feeds):
        return None
    return sum(f["refine_iters"] for f in feeds) / refined
