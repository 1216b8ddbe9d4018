"""The port's cost counter, on the CPU.

``repro_torch.launch.hlo_analysis`` holds a copy of the reference's HLO
analyzer (it must read the reference's HLO texts as the reference does) and
the port's own counter over a torch program.  The counter is held to the
reference's hand-computable programs (``tests/test_hlo_analysis.py``),
written in torch, at the reference's tolerances; to the reference's own
count of the same smoke prefill and decode; and to refusing to count a
program that launched a hand-written kernel.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro_torch.configs as tcfgs
from repro.launch import hlo_analysis as jhlo
from repro.models import decode as jdec
from repro.models import init_params as jinit_params
from repro_torch.configs.base import RunConfig
from repro_torch.launch import hlo_analysis as thlo
from repro_torch.models import steps
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import param_shapes
from repro_torch.optim import adamw

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
MM_FLOPS = 2 * 512**3


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


# -- the copy is the reference's ----------------------------------------------

POD_SPLIT_HLO = """
HloModule test

ENTRY %main.1 (p: f32[256]) -> f32[256] {
  %p = f32[256]{0} parameter(0)
  %ag = f32[512]{0} all-gather(%p), replica_groups=[256,2]<=[2,256]T(1,0), dimensions={0}
  %ar = f32[256]{0} all-reduce(%p), replica_groups=[32,16]<=[512], to_apply=%add
  ROOT %r = f32[256]{0} add(%ar, %ar)
}
"""

NESTED_TUPLE_HLO = """
%body.1 (arg: (s32[], /*index=1*/f32[8,8])) -> (s32[], f32[8,8]) {
  %arg = (s32[], f32[8,8]{1,0}) parameter(0)
  %g = s32[] get-tuple-element(%arg), index=0
  ROOT %t = (s32[], f32[8,8]{1,0}) tuple(%g, %g)
}
"""


def _jax_hlo(name: str) -> str:
    a = jax.ShapeDtypeStruct((512, 512), jnp.bfloat16)
    if name == "matmul":
        fn = lambda x, y: x @ y  # noqa: E731
    else:
        def fn(x, y):
            def body(c, _):
                return jax.nn.relu(c @ y), None
            return jax.lax.scan(body, x, None, length=8)[0]
    return jax.jit(fn).lower(a, a).compile().as_text()


@pytest.mark.parametrize("program", ["pod_split", "nested_tuple", "matmul", "scan8"])
def test_analyze_is_the_reference_s(program):
    """The copied ``analyze`` and ``parse_computations`` give the reference's
    results field for field."""
    hlo = {"pod_split": POD_SPLIT_HLO, "nested_tuple": NESTED_TUPLE_HLO}.get(program)
    hlo = hlo or _jax_hlo(program)
    got, want = thlo.analyze(hlo), jhlo.analyze(hlo)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert ({k: [dataclasses.asdict(o) for o in c.ops]
             for k, c in thlo.parse_computations(hlo).items()}
            == {k: [dataclasses.asdict(o) for o in c.ops]
                for k, c in jhlo.parse_computations(hlo).items()})
    if program == "pod_split":
        assert got.collectives["all-gather"]["dcn_bytes"] == 512 * 4


# -- the counter on the reference's hand-computable programs ------------------

def _loop8(x, y):
    for _ in range(8):
        x = torch.relu(x @ y)
    return x


def _loops3x4(x, y):
    for _ in range(3):
        for _ in range(4):
            x = (x @ y).to(x.dtype)
    return x


def _fori5(x, y):
    for _ in range(5):
        x = (x @ y).to(x.dtype)
    return x


@pytest.mark.parametrize("fn, times", [(lambda x, y: x @ y, 1), (_loop8, 8), (_loops3x4, 12),
                                       (_fori5, 5)], ids=["single", "loop8", "loops3x4", "fori5"])
def test_counter_matmul_flops(fn, times):
    a = _meta(512, 512)
    assert thlo.count(fn, a, a).dot_flops == pytest.approx(times * MM_FLOPS, rel=0.01)


def test_counter_narrow_traffic_is_slice_sized():
    """A narrow of 16 rows of a big tensor is a view: the product reads only
    the slice, well under one full read of the tensor (16 MB)."""
    big = torch.zeros(4096, 1024)
    c = thlo.count(lambda x: x.narrow(0, 7, 16) * 2.0, big)
    assert 0 < c.hbm_bytes < 4096 * 1024 * 4 * 0.5
    assert c.hbm_bytes == 2 * 16 * 1024 * 4


_WORLD = """
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.comms import routes
from repro_torch.launch.hlo_analysis import count

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
pairs = dist.new_group([0, 256])  # chip i with i + 256: crosses the pods
block = dist.new_group(list(range(16)))  # 16 consecutive chips: one pod

def ag(p):
    out = p.new_empty((512,))
    routes.all_gather(out, p, pairs)
    return out

def ar(p):
    routes.all_reduce(p, block)
    return p + p

p = torch.zeros(256, dtype=torch.float32)
print(json.dumps({"ag": count(ag, p).collectives, "ar": count(ar, p).collectives}))
dist.destroy_process_group()
"""


def test_counter_collective_bytes_and_pod_split():
    """In a 512-rank fake world: an all-gather over {0, 256} is DCN, an
    all-reduce over 16 consecutive ranks is ICI (the reference's pod split)."""
    import json

    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _WORLD], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["ag"]["all-gather"] == {"count": 1.0, "ici_bytes": 0.0, "dcn_bytes": 512 * 4}
    assert got["ar"]["all-reduce"] == {"count": 1.0, "ici_bytes": 256 * 4, "dcn_bytes": 0.0}


def test_remat_increases_flops():
    """Per-block remat recomputes the forward during backward, under the
    counter: visible as extra dot flops (the reference's > 1.1x)."""
    cfg = tcfgs.smoke_config("llama3.2-1b")
    flops = {}
    for remat in (False, True):
        params = param_shapes(cfg)
        run = RunConfig(model=cfg, n_microbatches=1, remat=remat)
        batch = {"tokens": torch.empty((2, 32), dtype=torch.int32, device="meta")}
        flops[remat] = thlo.count(functools.partial(steps.train_step, cfg, run), params,
                                  adamw.init_state(params), batch).dot_flops
    assert flops[True] > flops[False] * 1.1


# -- the counter against the reference's count of the same program ------------

# measured: the port's counter and the reference's analyze agree to 0 on the
# smoke llama prefill and decode (the same products, one dot each); the gate
# leaves room for a dot XLA folds, which the counter would still count
REF_TOL = 0.01


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_counter_matches_reference_count(step):
    """The smoke llama3.2-1b prefill and decode step in f32 on one device, on
    the reference's weights: the counter's ``dot_flops`` against the
    reference's ``analyze`` of the same jitted program."""
    name = "llama3.2-1b"
    jc = dataclasses.replace(jcfgs.smoke_config(name), dtype="float32")
    tc = dataclasses.replace(tcfgs.smoke_config(name), dtype="float32")
    jp = jinit_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jp)
    B, S = 2, 16
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    if step == "prefill":
        hlo = jax.jit(lambda p, t: jdec.prefill(jc, p, t)).lower(jp, toks).compile().as_text()
        got = thlo.count(steps.prefill_step, tc, tp, torch.from_numpy(toks))
    else:
        _, jcache = jax.jit(lambda p, t: jdec.prefill(jc, p, t, capacity=S + 4))(jp, toks)
        tok = toks[:, -1:]
        hlo = (jax.jit(lambda p, c, t, q: jdec.decode_step(jc, p, c, t, q))
               .lower(jp, jcache, tok, jnp.int32(S)).compile().as_text())
        _, tcache = steps.prefill_step(tc, tp, torch.from_numpy(toks), capacity=S + 4)
        got = thlo.count(steps.decode_step, tc, tp, tcache, torch.from_numpy(tok), S)
    want = jhlo.analyze(hlo).dot_flops
    assert want > 0
    assert got.dot_flops == pytest.approx(want, rel=REF_TOL)


def test_counter_refuses_a_kernel_launch():
    """A hand-written kernel's work is invisible to the counter: a program
    during which a wrapper's ``launches`` counter moves makes it raise.  A
    stub stands in for the launch (no card here)."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    def launches_a_kernel(x):
        fa_kernel.launches += 1
        return x * 2

    before = fa_kernel.launches
    try:
        with pytest.raises(RuntimeError, match="kernels launched while counting"):
            thlo.count(launches_a_kernel, torch.zeros(4))
        assert thlo.count(lambda x: x * 2, torch.zeros(4)).hbm_bytes == 32
    finally:
        fa_kernel.launches = before
