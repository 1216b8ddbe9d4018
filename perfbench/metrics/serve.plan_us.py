"""The planner's consult before each decode step (the host clock around
``select_allreduce_strategy``): its total over the window over the count."""
UNIT, RUN, SOURCE = "us", "traced", "host_clock"


def read(run):
    plans = [s for b in run.batches for s in b.plan_s]
    return 1e6 * sum(plans) / len(plans) if plans else None
