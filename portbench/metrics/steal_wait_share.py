"""The share of the scan's thread time spent outside operator B over the
window: 1 - (thread-seconds inside operator applications, ``op_s``) /
(the scan's threads times its wall time: the thread-seconds its pool tasks
and its phase 2 held, ``task_s``, and those its threads held no task,
``wait_s``), over the feeds whose scan ran pool tasks, from
``SeriesResult.feeds``.  What is left is waiting: threads idle between and
after their phase-1 tasks and through phase 2, lost takes and their
backoffs, and the Python between applications."""


def read(ctx):
    feeds = [f for f in ctx["result"].feeds if f.get("task_s", 0) > 0]
    held = sum(f["task_s"] + f["wait_s"] for f in feeds)
    if not held:
        return None
    return 1.0 - sum(f["op_s"] for f in feeds) / held
