"""The whole serving batch's share of the card's bf16 peak: the model's
useful FLOPs of the window's batches (``run.work.batch_flops``: experts at
top_k, attention over the attended positions) over the window's host
time, against 989 TFLOP/s."""
UNIT, RUN, SOURCE = "%", "traced", "host_clock"


def read(run):
    if run.peaks is None:
        return None
    t = run.traffic
    flops = len(run.batches) * run.work.batch_flops(run.model, t["batch"], t["prompt_len"],
                                                    t["new_tokens"])
    return 100.0 * flops / run.window_s / run.peaks["bf16_flops_per_s"]
