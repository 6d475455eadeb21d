"""Function A's milliseconds a batched gradient step over the window: the
feeds' function A seconds (``fnA_s``, their ``preprocess`` clocks) over the
batched steps they ran (``fnA_steps``), from ``SeriesResult.feeds``."""


def read(ctx):
    feeds = ctx["result"].feeds
    steps = sum(f.get("fnA_steps", 0) for f in feeds)
    if not steps:
        return None
    return 1e3 * sum(f["fnA_s"] for f in feeds) / steps
