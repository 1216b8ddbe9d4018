"""The trace arithmetic (``perfbench/devtrace.py``) on a made-up profile:
the busy union clipped to the window, device time and launches by name,
idle time by the host phase around it, and the flash roofline's reader."""
from __future__ import annotations

import types

import pytest
from torch.autograd import DeviceType

from perfbench import devtrace
from perfbench.serving import PHASES


class _Event:
    def __init__(self, name, device, start, end, annotation=False):
        self._v = (name, device, start, end, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def is_user_annotation(self):
        return self._v[4]

    def correlation_id(self):
        return 0


def _profile(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
US = 1000
EVENTS = [
    _Event(devtrace.WINDOW, CPU, 100 * US, 1100 * US),
    _Event("prefill", CPU, 100 * US, 400 * US),
    _Event("decode.step0", CPU, 400 * US, 800 * US),
    _Event("prefill", CUDA, 100 * US, 400 * US, annotation=True),  # a phase mirrored
    _Event("before", CUDA, 0, 150 * US),  # clipped to the window: 50 us
    _Event("flash_fwd_wgmma_kernel<128>", CUDA, 150 * US, 250 * US),
    _Event("gemm", CUDA, 200 * US, 300 * US),  # overlaps flash: the union counts 150-300
    _Event("flash_fwd_wgmma_kernel<128>", CUDA, 305 * US, 405 * US),  # a 5 us gap before
    _Event("gemm", CUDA, 700 * US, 1000 * US),  # 295 us idle in decode.step0 before it
]


def test_busy_ops_and_idle_by_phase():
    t = devtrace.read(_profile(EVENTS), PHASES)
    assert t.window_s == pytest.approx(1000e-6)
    assert t.busy_s == pytest.approx((300 - 100 + 405 - 305 + 1000 - 700) * 1e-6)
    assert t.kernel("flash_fwd") == (2, pytest.approx(200e-6))
    assert t.op_seconds["before"] == pytest.approx(50e-6)
    assert "prefill" not in t.op_seconds
    idle = dict(t.top_idle())
    assert idle[devtrace.SHORT_GAP] == pytest.approx(5e-6)
    assert idle["decode.step0"] == pytest.approx(295e-6)
    assert idle[devtrace.HOST_IDLE] == pytest.approx(100e-6)  # 1000-1100, after the phases
    assert t.top_ops(1)[0][0] == "gemm"


def test_flash_roofline_reads_each_recorded_launch():
    import importlib.util

    from conftest import ROOT
    from perfbench.work import serve as work
    from perfbench.work.peaks import peaks

    path = ROOT / "perfbench/metrics/flash_attention_roofline.py"
    spec = importlib.util.spec_from_file_location("roofline", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    model = {"d_model": 256, "n_heads": 2, "n_kv_heads": 2, "head_dim": 128, "d_ff": 512,
             "vocab_size": 512, "groups": [{"pattern": ["attn"], "count": 2}],
             "norm": "rmsnorm", "dtype": "bfloat16"}
    traffic = {"batch": 2, "prompt_len": 64, "new_tokens": 4}
    h100 = peaks("NVIDIA H100 80GB HBM3")
    least = work.least_seconds(work.flash_launch_flops(model, 2, 64),
                               work.flash_launch_bytes(model, 2, 64), h100)
    trace = devtrace.read(_profile(EVENTS), PHASES)  # two launches, 200 us in all
    run = types.SimpleNamespace(trace=trace, peaks=h100, traffic=traffic, model=model,
                                work=work)
    assert reader.read(run) == pytest.approx(100.0 * least * 2 / 200e-6)
    run.trace = None
    assert reader.read(run) is None
