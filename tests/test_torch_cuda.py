"""The two Hopper segagg kernels against their plain PyTorch version, on
the card.  Marked ``cuda``: they skip without a CUDA card (the kernels have
no CPU mode).  This file imports no JAX, so it runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.segagg import ops
from repro_torch.kernels.segagg.ref import segagg_ref
from repro_torch.kernels.segagg.segagg import (
    NARROW_TABLE_BYTES,
    segagg_narrow_cuda,
    segagg_scatter_cuda,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the segagg kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(n, g, v, seed, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    keys = rng.integers(lo, g if hi is None else hi, n).astype(np.int32)
    vals = rng.standard_normal((n, v)).astype(np.float32)
    return keys, vals


@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize("fn, g", [(segagg_narrow_cuda, 1), (segagg_narrow_cuda, 5),
                                       (segagg_scatter_cuda, 5),
                                       (segagg_scatter_cuda, 360_000)])
    @pytest.mark.parametrize("v", [1, 3])
    def test_kernel_matches_plain_version(self, cuda, fn, g, v):
        keys, vals = _inputs(100_003, g, v, seed=g + v, lo=-2, hi=g + 2)
        k, x = torch.from_numpy(keys).to(cuda), torch.from_numpy(vals).to(cuda)
        ones = torch.ones_like(x)
        assert torch.equal(fn(k, ones, g), segagg_ref(k, ones, g))
        torch.testing.assert_close(fn(k, x, g).double(), segagg_ref(k, x.double(), g),
                                   rtol=1e-4, atol=1e-4)

    def test_narrow_refuses_a_table_that_does_not_fit(self, cuda):
        g = NARROW_TABLE_BYTES // 4 + 1
        k = torch.zeros(8, dtype=torch.int32, device=cuda)
        before = segagg_narrow_cuda.launches
        with pytest.raises(ValueError, match="shared memory"):
            segagg_narrow_cuda(k, torch.ones((8, 1), device=cuda), g)
        assert segagg_narrow_cuda.launches == before

    def test_ops_on_card_launches_a_kernel(self, cuda):
        keys, vals = _inputs(10_000, 5, 1, seed=2)
        k, x = torch.from_numpy(keys).to(cuda), torch.from_numpy(vals).to(cuda)
        narrow, scatter = segagg_narrow_cuda.launches, segagg_scatter_cuda.launches
        ops.segagg(k, x, 5)
        ops.segagg(k, x, 100_000)
        assert segagg_narrow_cuda.launches == narrow + 1
        assert segagg_scatter_cuda.launches == scatter + 1
