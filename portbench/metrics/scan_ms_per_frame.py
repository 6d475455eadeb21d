"""The scan stage's milliseconds a frame over the window: the program's
``scan`` stage seconds (``SeriesResult.timings``: the guess checks and
refinements of operator B, or the composing scan, each feed synced) over
the elements the window folded in."""


def read(ctx):
    pairs = ctx["window"]["pairs"]
    secs = ctx["result"].timings.get("scan")
    if not pairs or secs is None:
        return None
    return 1e3 * secs / pairs
