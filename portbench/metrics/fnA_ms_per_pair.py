"""Function A's milliseconds a frame pair over the window: the program's
``preprocess`` stage seconds (``SeriesResult.timings``, synced on every
gradient iteration) over the pairs the window registered."""


def read(ctx):
    pairs = ctx["window"]["pairs"]
    secs = ctx["result"].timings.get("preprocess")
    if not pairs or not secs:
        return None
    return 1e3 * secs / pairs
