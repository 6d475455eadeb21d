"""The share of function A's lane-steps that did work over the window: the
lanes' own iterations (``pair_iters``) over the lane-steps the batched
descent paid for (``fnA_lane_steps``: each step times its sub-batch's
width; a sub-batch steps until its slowest lane stops), from
``SeriesResult.feeds``."""


def read(ctx):
    feeds = ctx["result"].feeds
    paid = sum(f.get("fnA_lane_steps", 0) for f in feeds)
    if not paid:
        return None
    return sum(f["pair_iters"] for f in feeds) / paid
