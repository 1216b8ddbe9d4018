"""``train_step`` of the port against the JAX package's, f32, smoke width:
llama3.2-1b, rwkv6-1.6b, recurrentgemma-9b, olmo-1b and codeqwen1.5-7b
(the other five archs are in ``test_torch_train_archs_b.py``).  Two steps
with ``warmup_steps=1``: the first at lr 0 (moments only), the second
moves every weight.  Loss, ce, aux, grad_norm and lr each step, then every
parameter, ``mu`` and ``nu`` leaf at 1e-4 of the leaf's largest magnitude:
both sides compute in f32 and differ in the order of their sums."""
import pytest
import torch

from _torch_train_parity import check_train_step

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-1.6b", "recurrentgemma-9b", "olmo-1b",
                                  "codeqwen1.5-7b"])
def test_train_step_matches_reference(arch):
    check_train_step(arch)
