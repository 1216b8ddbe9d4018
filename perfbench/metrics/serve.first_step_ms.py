"""DecodeGraph's step 0 (its eager warm-up) and the capture, a batch: the
program's ``first_step_seconds`` over the window's batches, their mean.
Off the card nothing is captured and there is nothing to read."""
UNIT, RUN, SOURCE = "ms", "traced", "program_counter"


def read(run):
    steps = [b.first_step_s for b in run.batches if b.capture_s > 0]
    return 1e3 * sum(steps) / len(steps) if steps else None
