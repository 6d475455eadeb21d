"""The share of operator B's guess checks that went on to refine, over the
window: refined / (skipped + refined) from ``SeriesResult.feeds``.  Nothing
to read where no guess check ran (a composing session)."""


def read(ctx):
    feeds = ctx["result"].feeds
    refined = sum(f["refined"] for f in feeds)
    checks = refined + sum(f["skipped"] for f in feeds)
    if not checks:
        return None
    return refined / checks
