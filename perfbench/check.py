"""``correct``: the served tokens of a sample of the window's requests
against the plain float32 reference.

Once the window has closed, a sample of its finished requests is drawn from
the seed (``traffic["check_requests"]`` of them; every request of a cell
has the same length, so the sample holds the longest).  The reference runs
once over each sampled prompt followed by its served tokens and gives the
logits at every position that picked a served token: prefill's last
position and each decode step.  A served token's gap is the reference's
best logit there less the reference's logit of the served token: 0 where
the program picked the reference's argmax, small where rounding flipped a
near tie, large where the program computed something else.  The sample
reads its widest gap, its mean gap and the share of its tokens off the
reference's argmax (``numbers``); a cell's ``checks/<cell>.json`` names
those it compares and each one's limit, set from the program's and the
control's readings (``calibrate``).  This is valid for greedy decoding
only.

The control (``control_gaps``) puts the reference in the program's place
with every weight product rounded to float8 e4m3: at each position of the
same sequences it reads the gap of the token the control ranks first.

The reference is the configuration's own module (``reference``, found by
``Spec.reference``: ``perfbench/reference/<name>.py``), its ``logits``;
the precision of both readings is one for every model
(``reference/precision.py``).  Nothing here depends on the model: a new
configuration brings its reference as a new module.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.reference import precision
from perfbench.serving import Batch, prompts
from perfbench.weights import sub_seed

REF_BLOCK = 16  # requests a reference pass


def sample(batches: List[Batch], batch_size: int, k: int, seed: int) -> List[Tuple[int, int]]:
    """(batch index, row) of ``k`` finished requests drawn from the seed."""
    pool = [(b.index, r) for b in batches for r in range(batch_size)]
    pick = np.random.default_rng(sub_seed(seed, "sample")).choice(
        len(pool), size=min(k, len(pool)), replace=False)
    return [pool[i] for i in sorted(pick)]


def sequences(batches: List[Batch], chosen, traffic: dict, model: dict, seed: int, device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(prompt + served tokens but the last (R, P + N - 1), served (R, N))."""
    by_index = {b.index: b for b in batches}
    seqs, served = [], []
    for index in sorted({i for i, _ in chosen}):
        rows = [r for i, r in chosen if i == index]
        p = prompts(traffic, model, seed, index, device)[rows].long()
        s = torch.from_numpy(by_index[index].tokens[rows]).to(device)
        seqs.append(torch.cat([p, s[:, :-1]], dim=1))
        served.append(s)
    return torch.cat(seqs), torch.cat(served)


def _ref_logits(reference, model, params, seqs, first, linear):
    for s in range(0, seqs.shape[0], REF_BLOCK):
        yield reference.logits(model, params, seqs[s:s + REF_BLOCK], first, linear)


def served_gaps(reference, model: dict, params: dict, seqs: torch.Tensor,
                served: torch.Tensor, prompt_len: int) -> np.ndarray:
    """(R, N) gap of each served token under the float32 reference of the
    model's module ``reference``."""
    precision.set_precision()
    out = []
    first = prompt_len - 1
    with torch.no_grad():
        for s, ref in zip(range(0, seqs.shape[0], REF_BLOCK), _ref_logits(
                reference, model, params, seqs, first, precision.f32_linear)):
            picked = ref.gather(-1, served[s:s + REF_BLOCK, :, None])[..., 0]
            out.append((ref.max(-1).values - picked).cpu().numpy())
    return np.concatenate(out)


def control_gaps(reference, model: dict, params: dict, seqs: torch.Tensor,
                 prompt_len: int) -> np.ndarray:
    """(R, N) gap, under the float32 reference, of the token the float8
    control ranks first at each position of ``seqs``."""
    precision.set_precision()
    out = []
    first = prompt_len - 1
    with torch.no_grad():
        for ref, low in zip(
                _ref_logits(reference, model, params, seqs, first, precision.f32_linear),
                _ref_logits(reference, model, params, seqs, first, precision.fp8_linear)):
            picked = ref.gather(-1, low.argmax(-1, keepdim=True))[..., 0]
            out.append((ref.max(-1).values - picked).cpu().numpy())
    return np.concatenate(out)


def numbers(gaps: np.ndarray) -> Dict[str, float]:
    """What a sample's gaps (R, N) read: the widest gap, the mean gap and
    the share of served tokens off the reference's argmax."""
    return {"max_logit_gap": float(gaps.max()), "mean_logit_gap": float(gaps.mean()),
            "off_argmax_share": float((gaps > 0).mean())}


def judge(read: Dict[str, float], checks: Dict[str, dict], requests: int
          ) -> Tuple[Dict[str, dict], int]:
    """({number: {"value", "limit"}} for each number the cell's checks file
    limits, requests failed): the sample is judged as a whole, so where a
    number passes its limit every sampled request counts as failed."""
    checked = {name: {"value": read[name], "limit": c["limit"]} for name, c in checks.items()}
    ok = all(c["value"] <= c["limit"] for c in checked.values())
    return checked, 0 if ok else requests
