"""A replayed decode step (one ``DecodeGraph`` replay): CUDA events around
every replay of the window, their total over the count."""
UNIT, RUN, SOURCE = "ms", "traced", "device_trace"


def read(run):
    steps = [ms for b in run.batches for ms in b.replay_ms]
    return sum(steps) / len(steps) if steps else None
