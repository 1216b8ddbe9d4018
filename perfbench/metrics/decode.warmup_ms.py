"""DecodeGraph's step 0 up to the end of the wait for it, a batch: the
program's ``first_step_seconds`` less its ``capture_seconds``, over the
window's captured batches, their mean.  That is the program's
``warmup_seconds`` (the ``graph.warmup`` and ``graph.warmup.wait`` spans on
the host clock, up to where the capture's clock starts) and the few
statements after the capture.  Off the card nothing is captured and there
is nothing to read."""
UNIT, RUN, SOURCE = "ms", "traced", "program_counter"


def read(run):
    steps = [b.first_step_s - b.capture_s for b in run.batches if b.capture_s > 0]
    return 1e3 * sum(steps) / len(steps) if steps else None
