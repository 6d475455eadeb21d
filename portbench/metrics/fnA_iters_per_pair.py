"""Function A's gradient iterations a frame pair over the window: the
feeds' ``pair_iters`` (each lane's own iterations, summed) over their
elements, from ``SeriesResult.feeds``."""


def read(ctx):
    feeds = ctx["result"].feeds
    pairs = sum(f["n_elems"] for f in feeds)
    if not pairs or any("pair_iters" not in f for f in feeds):
        return None
    return sum(f["pair_iters"] for f in feeds) / pairs
