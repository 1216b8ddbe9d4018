"""The program's spans read from a made-up profile (``perfbench/spans.py``):
device operations charged by correlation id to the innermost program span
around their launch, launches outside every span and graph replays to
``(none)``, idle by the innermost span or else the harness's phase;
``devtrace`` unchanged by the spans; and the step-0 counters' readers."""
from __future__ import annotations

import importlib.util
import types

import pytest
from torch.autograd import DeviceType

from conftest import ROOT
from perfbench import devtrace, spans
from perfbench.serving import PHASES

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
US = 1000


class _Event:
    def __init__(self, name, device, start, end, corr=0, annotation=False):
        self._v = (name, device, start * US, end * US, corr, annotation)

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

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def _span(name, start, end):
    return _Event(name, CPU, start, end, annotation=True)


def _launch(corr, at):
    return _Event("cudaLaunchKernel", CPU, at, at + 3, corr=corr)


def _kernel(name, corr, start, end):
    return _Event(name, CUDA, start, end, corr=corr)


def _profile(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


HARNESS = [
    _span(devtrace.WINDOW, 0, 1000),
    _span("prefill", 0, 300), _span("decode.step0", 300, 700),
    _span("decode.replay", 700, 950),
]
PROGRAM = [  # the program's spans and their mirrors on the device
    _span("model.prefill", 10, 290), _span("model.attention", 20, 100),
    _span("model.ffn", 120, 250), _span("model.head", 260, 285),
    _span("graph.warmup", 300, 400), _span("model.decode_step", 305, 395),
    _span("model.attention", 310, 350), _span("graph.warmup.wait", 400, 450),
    _span("graph.capture", 450, 650), _span("graph.capture.record", 460, 640),
    _Event("model.prefill", CUDA, 20, 255, annotation=True),
]
WORK = [
    _launch(6, 5), _kernel("embed", 6, 0, 10),  # before every program span
    _launch(4, 15), _kernel("gather", 4, 20, 38),  # prefill's own
    _launch(1, 30), _kernel("flash_fwd", 1, 40, 90),
    _launch(2, 130), _kernel("gemm", 2, 140, 240),
    _launch(3, 200), _kernel("silu", 3, 245, 255),
    _launch(5, 320), _kernel("gemv", 5, 330, 380),  # step 0's attention
    _launch(8, 390), _kernel("copy", 8, 400, 420),  # step 0's own
    _Event("cudaGraphLaunch", CPU, 710, 712, corr=7),
    _kernel("gemv", 7, 720, 800),  # a replay's kernel
    _kernel("gemm", 99, 850, 860),  # no launch recorded
    _Event("aten::mm", CPU, 905, 910, corr=5),  # an op's id is no launch's
]


def test_operations_go_to_the_innermost_span_around_their_launch():
    t = spans.read(_profile(HARNESS + PROGRAM + WORK), PHASES)
    assert {k: round(v * 1e6, 6) for k, v in t.op_seconds.items()} == {
        spans.NONE: 10 + 80 + 10, "model.prefill": 18,
        "model.prefill/model.attention": 50, "model.prefill/model.ffn": 110,
        "graph.warmup/model.decode_step/model.attention": 50,
        "graph.warmup/model.decode_step": 20}
    assert t.op_counts[spans.NONE] == 3 and t.op_counts["model.prefill/model.ffn"] == 2
    assert t.unlaunched_s == pytest.approx(10e-6)  # the kernel of id 99
    assert t.by_name[spans.NONE, "gemv"] == pytest.approx(80e-6)
    assert t.by_name["model.prefill", "gather"] == pytest.approx(18e-6)
    assert t.calls == {"model.prefill": 1, "model.prefill/model.attention": 1,
                       "model.prefill/model.ffn": 1, "model.prefill/model.head": 1,
                       "graph.warmup": 1, "graph.warmup/model.decode_step": 1,
                       "graph.warmup/model.decode_step/model.attention": 1,
                       "graph.warmup.wait": 1, "graph.capture": 1,
                       "graph.capture/graph.capture.record": 1}
    assert t.host_seconds["graph.capture"] == pytest.approx(200e-6)
    assert t.under("model.prefill") == pytest.approx(178e-6)
    assert t.coverage("model.prefill") == pytest.approx(160 / 178)
    assert t.coverage(spans.STEP0) == pytest.approx(50 / 70)
    got = spans.layer_ms(t)
    assert got == pytest.approx({"prefill.attention_ms": 0.05, "prefill.ffn_ms": 0.11,
                                 "decode.attention_ms": 0.05, "decode.ffn_ms": 0.0})


def test_idle_goes_to_the_innermost_span_else_the_phase():
    t = spans.read(_profile(HARNESS + PROGRAM + WORK), PHASES)
    assert {k: round(v * 1e6, 6) for k, v in t.idle.items()} == {
        devtrace.SHORT_GAP: 10 + 2 + 5,  # 10-20, 38-40, 240-245
        "model.prefill": 50,  # 90-140, between attention and the MLP
        "prefill": 75,  # 255-330: its midpoint after model.prefill, in the phase
        "graph.warmup/model.decode_step": 20,  # 380-400
        "graph.capture/graph.capture.record": 300,  # 420-720
        "decode.replay": 50 + 140}  # 800-850, and 860-1000 by its midpoint
    assert t.top_idle(1) == [("graph.capture/graph.capture.record", pytest.approx(300e-6))]
    trace = devtrace.read(_profile(HARNESS + PROGRAM + WORK), PHASES)
    split = spans.summary(t, trace)
    assert split["step0_idle_in_graph_spans"] == pytest.approx(320 / 320)
    assert split["step0_device_ms"] == pytest.approx(0.07)
    assert split["top_ops"]["model.prefill/model.ffn"] == [["gemm", pytest.approx(0.1)],
                                                          ["silu", pytest.approx(0.01)]]


def test_devtrace_reads_the_same_with_the_programs_spans():
    bare = devtrace.read(_profile(HARNESS + WORK), PHASES)
    spanned = devtrace.read(_profile(HARNESS + PROGRAM + WORK), PHASES)
    assert spanned.op_seconds == bare.op_seconds and spanned.op_counts == bare.op_counts
    assert spanned.idle_by_phase == bare.idle_by_phase
    assert (spanned.busy_s, spanned.window_s) == (bare.busy_s, bare.window_s)
    # one walk over the profile, as the harness reads it, reads both the same
    both = devtrace.events(_profile(HARNESS + PROGRAM + WORK), PHASES, spans.HOST_PREFIXES)
    assert devtrace.trace(both) == spanned
    assert spans.split(both) == spans.read(_profile(HARNESS + PROGRAM + WORK), PHASES)


def test_no_program_span_reads_nothing():
    t = spans.read(_profile(HARNESS + WORK), PHASES)
    assert set(t.op_seconds) == {spans.NONE} and t.calls == {}
    assert set(spans.layer_ms(t).values()) == {None}
    assert t.coverage(spans.PREFILL) is None
    with pytest.raises(RuntimeError):
        spans.read(_profile(PROGRAM + WORK), PHASES)


def _reader(name):
    path = ROOT / "perfbench/metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name,want", [("decode.warmup_ms", (0.08 + 0.10) / 2 * 1e3),
                                       ("decode.capture_ms", (0.02 + 0.04) / 2 * 1e3)])
def test_step0_readers_read_the_captured_batches(name, want):
    reader = _reader(name)
    batch = types.SimpleNamespace
    run = types.SimpleNamespace(batches=[batch(first_step_s=0.10, capture_s=0.02),
                                         batch(first_step_s=0.14, capture_s=0.04)])
    assert reader.read(run) == pytest.approx(want)
    run.batches = [batch(first_step_s=0.05, capture_s=0.0)]  # off the card: no capture
    assert reader.read(run) is None
    run.batches = []
    assert reader.read(run) is None


@pytest.mark.cuda
def test_a_card_profile_charges_each_layer():
    """Smoke llama on the card, its prefill and a captured decode under
    ``torch.profiler``: prefill's and step 0's layers hold device time,
    the capture launches nothing, the replays' kernels are nobody's, and
    step 0 on the host clock is the warm-up and the capture."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the spans charge kernels the card ran")
    from repro_torch.configs import smoke_config
    from repro_torch.models import decode
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(smoke_config("llama3.2-1b"), dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(2, cfg.vocab_size, (2, 16), device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(devtrace.WINDOW):
            with record_function("prefill"):
                logits, caches = decode.prefill(cfg, params, tokens, capacity=20)
            graph = decode.DecodeGraph(cfg, params, caches, logits.argmax(-1)[:, None], 16, 4)
            for _ in range(4):
                graph.step()
            torch.cuda.synchronize()
    t = spans.read(prof, PHASES)
    assert t.calls[spans.PREFILL] == t.calls[spans.STEP0] == 1
    assert t.calls["graph.capture/graph.capture.record/model.decode_step"] == 1
    for parent in (spans.PREFILL, spans.STEP0):
        for layer in spans.COVERED:
            assert t.under(f"{parent}/{layer}") > 0, (parent, layer)
    # the capture runs none of the step's work; the replays' kernels are nobody's
    assert t.under("graph.capture") < 0.01 * t.under(spans.STEP0), t.op_seconds
    assert t.op_seconds[spans.NONE] > 0
    assert graph.warmup_seconds > 0 and graph.capture_seconds > 0
    assert 0 <= graph.first_step_seconds - graph.warmup_seconds - graph.capture_seconds < 1e-3


@pytest.mark.parametrize("name", ["prefill.attention_ms", "prefill.ffn_ms",
                                  "decode.attention_ms", "decode.ffn_ms"])
def test_span_readers_read_run_spans(name):
    """The layer readers read ``Run.spans`` as the harness keeps it: a
    hand-built ``SpanTrace`` of two prefills and two step 0s."""
    reader = _reader(name)
    t = spans.SpanTrace(
        op_seconds={"model.prefill/model.attention": 0.30, "model.prefill/model.ffn": 0.50,
                    "model.prefill": 0.02, spans.NONE: 1.0,
                    "graph.warmup/model.decode_step/model.attention": 0.008,
                    "graph.warmup/model.decode_step/model.attention/model.extra": 0.002,
                    "graph.warmup/model.decode_step/model.ffn": 0.004},
        op_counts={}, calls={"model.prefill": 2, "graph.warmup/model.decode_step": 2},
        host_seconds={}, idle={})
    want = {"prefill.attention_ms": 150.0, "prefill.ffn_ms": 250.0,
            "decode.attention_ms": 5.0, "decode.ffn_ms": 2.0}
    assert reader.read(types.SimpleNamespace(spans=t)) == pytest.approx(want[name])
    assert reader.read(types.SimpleNamespace(spans=None)) is None  # an untraced run
    empty = spans.SpanTrace({}, {}, {}, {}, {})  # a profile with no program span
    assert reader.read(types.SimpleNamespace(spans=empty)) is None
