"""Prefill's feed-forward layers (the MLP or the experts), a batch: the
device time of the operations launched under ``model.prefill/model.ffn`` in
the traced window, over the times ``model.prefill`` opened
(``spans.layer_ms`` of ``Run.spans``).  An untraced run, or one whose
profile holds no such span, has nothing to read."""
from perfbench import spans

UNIT, RUN, SOURCE = "ms", "traced", "program_span"


def read(run):
    return None if run.spans is None else spans.layer_ms(run.spans)["prefill.ffn_ms"]
