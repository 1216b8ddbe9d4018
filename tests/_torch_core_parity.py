"""Shared helpers of ``test_torch_core.py`` and ``test_torch_analysis.py``:
the reference's cost models, planner and simlint (``repro.core``,
``repro.analysis``) against the port's (``repro_torch.core``,
``repro_torch.analysis``) on the same inputs.

The two packages' dataclasses and enums are different classes with the same
names and fields, so results are compared by :func:`same`, field by field,
and never with ``==``.
"""
import dataclasses
import enum
import math
from collections.abc import Mapping

import numpy as np
import pytest
import torch

import repro.analysis as r_analysis
import repro.core as r_core
import repro.obs.drift as r_drift
import repro_torch.analysis as t_analysis
import repro_torch.core as t_core
import repro_torch.obs.drift as t_drift

# message sizes (0 - 16 MiB) and counts the closed forms are compared over
SIZES = (0.0, 1.0, 1024.0, 4096.0, 65536.0, float(1 << 20), float(1 << 24))
COUNTS = (1.0, 4.0, 32.0, 256.0)


def _key(k):
    """A mapping key as both packages can compare it (enum keys by name)."""
    return (type(k).__name__, k.name, k.value) if isinstance(k, enum.Enum) else k


def same(a, b, rel: float = 0.0, where: str = "$") -> None:
    """Assert ``a`` (reference) and ``b`` (port) hold the same values:
    dataclasses field by field (same class name), enums by name and value,
    mappings key by key in order, sequences item by item, floats and arrays
    exactly or within ``rel``."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert dataclasses.is_dataclass(b), where
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            same(getattr(a, f.name), getattr(b, f.name), rel, f"{where}.{f.name}")
    elif isinstance(a, enum.Enum):
        assert isinstance(b, enum.Enum), where
        assert (type(a).__name__, a.name, a.value) == (type(b).__name__, b.name, b.value), where
    elif isinstance(a, Mapping):
        assert isinstance(b, Mapping), where
        assert [_key(k) for k in a] == [_key(k) for k in b], where
        for ka, kb in zip(a, b):
            same(a[ka], b[kb], rel, f"{where}[{ka!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, rel, f"{where}[{i}]")
    elif isinstance(a, (np.ndarray, np.generic)):
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape and x.dtype == y.dtype, where
        if rel:
            np.testing.assert_allclose(y, x, rtol=rel, atol=0.0, err_msg=where)
        else:
            np.testing.assert_array_equal(y, x, err_msg=where)
    elif isinstance(a, float) and not isinstance(a, bool):
        assert isinstance(b, float), where
        if math.isnan(a):
            assert math.isnan(b), where
        elif rel:
            assert b == pytest.approx(a, rel=rel, abs=0.0), where
        else:
            assert b == a, where
    else:
        assert type(a) is type(b) and a == b, where


# the registry's built-in machines; tests elsewhere in a worker may have
# registered fitted ones in either package
BUILTIN = ("gh200", "lassen", "summit", "tpu_v5e")


@pytest.fixture(autouse=True)
def _both_packages_fresh():
    """Both packages as the suite runs the reference: strict validation on
    (the repository's conftest arms the reference's), one thread, empty
    lowering caches and drift ledgers."""
    torch.set_num_threads(1)
    t_analysis.set_strict(True)
    for core, drift in ((r_core, r_drift), (t_core, t_drift)):
        core.schedule.clear_schedule_cache()
        drift.reset()
    yield
    t_analysis.set_strict(None)
    for core, drift in ((r_core, r_drift), (t_core, t_drift)):
        core.schedule.clear_schedule_cache()
        drift.reset()

