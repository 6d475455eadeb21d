"""The guess check's kernels against their roofline, in %: the least time
of one check at the cell's frame size (``roofline.guess_check_work``: two
frames read, one number written) over the device time of the warp kernel
and its fold a check, from the profiler's trace.  Nothing to read where the
traced window ran no check."""

from portbench import roofline


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    warps = trace.ops("warp_ncc_kernel")
    if not warps:
        return None
    device_ns = sum(e - s for _, s, e in trace.ops("warp_ncc_kernel",
                                                  "warp_ncc_fold_kernel"))
    cfg = ctx["config"]
    nbytes, flops = roofline.guess_check_work(cfg["height"], cfg["width"])
    per_check_s = device_ns * 1e-9 / len(warps)
    return 100.0 * roofline.bound_s(nbytes, flops) / per_check_s
