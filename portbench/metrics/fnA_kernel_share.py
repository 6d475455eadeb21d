"""The share of function A's gradient steps that ran on its kernels
(``ncc_grad``) over the window: (Σ``fnA_kernel_steps`` +
Σ``refine_kernel_steps``) / (Σ``fnA_steps`` + Σ``refine_iters``), the
batched steps of the feeds' pairs and the refinements' steps, from
``SeriesResult.feeds``.  Nothing to read where no step ran, or where the
feed records lack the kernel counters (a program without them)."""


def read(ctx):
    feeds = ctx["result"].feeds
    if any("fnA_kernel_steps" not in f for f in feeds):
        return None
    steps = sum(f.get("fnA_steps", 0) + f.get("refine_iters", 0) for f in feeds)
    if not steps:
        return None
    kernel = sum(f["fnA_kernel_steps"] + f.get("refine_kernel_steps", 0)
                 for f in feeds)
    return kernel / steps
