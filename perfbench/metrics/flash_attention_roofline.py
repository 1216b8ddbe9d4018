"""The flash kernel's share of its roofline in prefill: each recorded
launch (kernels named ``flash_fwd...`` in the profiler's trace; one a layer
a prefill, all of the cell's shape) against the larger of its FLOPs at
989 TFLOP/s and its bytes at 3.35 TB/s (``run.work.flash_launch_*``),
summed over the launches the trace recorded, over their device time."""
UNIT, RUN, SOURCE = "%", "traced", "device_trace"
KERNEL = "flash_fwd"


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    launches, seconds = run.trace.kernel(KERNEL)
    if not launches:
        return None
    t, m = run.traffic, run.model
    windows = {m.get("window", 0) if k == "local" else 0
               for g in m["groups"] for k in g["pattern"]}
    if len(windows) != 1:
        return None  # launches of different windows are not told apart here
    least = run.work.least_seconds(
        run.work.flash_launch_flops(m, t["batch"], t["prompt_len"], windows.pop()),
        run.work.flash_launch_bytes(m, t["batch"], t["prompt_len"]), run.peaks)
    return 100.0 * least * launches / seconds
