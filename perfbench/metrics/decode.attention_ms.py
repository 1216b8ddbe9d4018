"""Decode's attention layers, a step: the device time of the operations
launched under ``graph.warmup/model.decode_step/model.attention`` (step 0,
DecodeGraph's eager run of the step it captures, on a replay's shapes) in
the traced window, over the times that step opened (``spans.layer_ms`` of
``Run.spans``).  An untraced run, or one whose profile holds no such span,
has nothing to read."""
from perfbench import spans

UNIT, RUN, SOURCE = "ms", "traced", "program_span"


def read(run):
    return None if run.spans is None else spans.layer_ms(run.spans)["decode.attention_ms"]
