"""DecodeGraph's capture, a batch: the program's ``capture_seconds`` (the
host clock from the end of the wait for step 0 to the end of the
``graph.capture`` span: the step recorded and the graph instantiated) over
the window's captured batches, their mean.  Off the card nothing is
captured and there is nothing to read."""
UNIT, RUN, SOURCE = "ms", "traced", "program_counter"


def read(run):
    captures = [b.capture_s for b in run.batches if b.capture_s > 0]
    return 1e3 * sum(captures) / len(captures) if captures else None
