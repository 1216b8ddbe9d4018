"""Rank program for ``tests/test_torch_elastic.py``'s resume check.  It lives
in a module of its own, which imports no JAX, because every spawned rank
imports the module of the function it runs."""
import torch.distributed as tdist

from repro_torch.checkpoint import Checkpointer
from repro_torch.launch import train

COLLECTIVES = ("all_gather_into_tensor", "all_gather", "all_reduce", "all_to_all_single",
               "broadcast", "reduce_scatter_tensor", "barrier", "send", "recv")


def resume_program(device, cfg, run_cfg, mesh_shape: str, kw: dict) -> dict:
    """``launch.train.world_run`` with every collective of ``torch.distributed``
    counted from ``run``'s entry: how many ran before the first train step
    and how many inside ``Checkpointer.restore``."""
    calls, marks = [], {}
    for name in COLLECTIVES:
        real = getattr(tdist, name)

        def counted(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        setattr(tdist, name, counted)
    run, step, restore = train.run, train.train_step, Checkpointer.restore

    def run_spy(*a, **k):
        calls.clear()
        return run(*a, **k)

    def step_spy(*a, **k):
        marks.setdefault("before_first_step", list(calls))
        return step(*a, **k)

    def restore_spy(self, *a, **k):
        n = len(calls)
        out = restore(self, *a, **k)
        marks["in_restore"] = calls[n:]
        return out

    train.run, train.train_step, Checkpointer.restore = run_spy, step_spy, restore_spy
    losses, _ = train.world_run(device, cfg, run_cfg, mesh_shape, 1, kw)
    return {"losses": losses, **marks}
