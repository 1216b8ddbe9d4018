"""The replayed decode steps' share of the HBM roofline: their least bytes
(``run.work.decode_step_least_bytes``: the weights once, the filled K and
V once, the new K and V written once) over their time from CUDA
events, against 3.35 TB/s."""
UNIT, RUN, SOURCE = "%", "traced", "device_trace"


def read(run):
    if run.peaks is None:
        return None
    t = run.traffic
    P, B = t["prompt_len"], t["batch"]
    nbytes = seconds = 0.0
    for b in run.batches:
        for i, ms in enumerate(b.replay_ms, start=1):  # replay i is decode step i
            nbytes += run.work.decode_step_least_bytes(run.model, B, P + i)
            seconds += ms / 1e3
    if not seconds:
        return None
    return 100.0 * nbytes / seconds / run.peaks["hbm_bytes_per_s"]
