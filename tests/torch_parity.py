"""Helpers shared by the port's parity tests (`tests/test_torch_*.py`).

Data crosses between the JAX package and the port as numpy arrays; bf16
crosses as raw 16-bit words.
"""

import ml_dtypes
import numpy as np
import pytest
import torch


def to_torch(a) -> torch.Tensor:
    """JAX or numpy array -> CPU torch tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def to_np(t) -> np.ndarray:
    """torch tensor or JAX array -> numpy; bf16 goes to float32 (exact)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.fixture(scope="module")
def torch_threads():
    """Two intra-op threads per test worker: the suite runs several workers,
    and wall-clock tests elsewhere must not starve."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def rel_l2(want, got) -> float:
    """||got - want|| / ||want|| in float64 (torch tensors or arrays)."""
    want, got = to_np(want).astype(np.float64), to_np(got).astype(np.float64)
    return float(np.linalg.norm(want - got) / max(np.linalg.norm(want), 1e-30))

