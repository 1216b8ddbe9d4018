"""95th percentile of the gaps between consecutive tokens of each request,
over every request of the window.  A token arrives when its ids reach the
host; the gap from the first token (prefill's pick) to the second holds
step 0's eager run and the graph capture.  Every request of a batch shares
its batch's gaps, so each gap counts once for each request."""
import numpy as np

UNIT, RUN, SOURCE = "ms", "plain", "host_clock"


def read(run):
    B = run.traffic["batch"]
    gaps = np.concatenate([np.repeat(np.diff(b.arrivals), B) for b in run.batches])
    return float(np.percentile(gaps, 95) * 1e3) if gaps.size else None
