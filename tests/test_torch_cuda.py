"""The two Hopper segagg kernels against their plain PyTorch version, on
the card.  Marked ``cuda``: they skip without a CUDA card (the kernels have
no CPU mode).  This file imports no JAX, so it runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.segagg import ops, tuning
from repro_torch.kernels.segagg.ref import segagg_ref, zipf_keys
from repro_torch.kernels.segagg.segagg import (
    NARROW_TABLE_BYTES,
    scatter_caps,
    scatter_plan_for,
    segagg_narrow_cuda,
    segagg_scatter_atomic_cuda,
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
        # |values|: a group of ~20,000 signed terms cancels to a sum near 0,
        # where f32 atomics' run-dependent order shows as a large relative
        # error (6e-4 seen on the card); positive terms keep the relative
        # tolerance a measure of that order, as in chip_smoke.py.
        k, x = torch.from_numpy(keys).to(cuda), torch.from_numpy(np.abs(vals)).to(cuda)
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


def _scatter_keys(n, g, v, seed, cuda, zipf=False):
    """Keys out of range on both sides and on every edge of the plan's key
    ranges (and of a two-range plan's), the rest uniform or Zipf."""
    if zipf:
        keys = zipf_keys(n, g, seed).numpy()
    else:
        keys = np.random.default_rng(seed).integers(-3, g + 3, n).astype(np.int32)
    ranges = (scatter_plan_for(g, v, cuda).ranges
              + scatter_plan_for(g, v, cuda, max_ranges=4).ranges)
    edges = [b // v + d for lo, hi in ranges for b in (lo, hi) for d in (-1, 0, 1)]
    edges += [-(2**31), 2**31 - 1, -1, g, g - 1, 0]
    keys[: len(edges)] = np.clip(edges, -(2**31), 2**31 - 1)
    return torch.from_numpy(keys).to(cuda)


def _check_scatter(fn, k, x, g, **kw):
    ones = torch.ones_like(x)
    assert torch.equal(fn(k, ones, g, **kw), segagg_ref(k, ones, g))
    torch.testing.assert_close(fn(k, x, g, **kw).double(), segagg_ref(k, x.double(), g),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
class TestScatterOnCard:
    """The cluster-table scatter and the global-atomic kernel against the
    plain version: counts by ``torch.equal``, |values| sums within 1e-4."""

    @pytest.mark.parametrize("fn", [segagg_scatter_cuda, segagg_scatter_atomic_cuda])
    @pytest.mark.parametrize("g", [5, 360_000, 1_500_000, 16_000_000])
    @pytest.mark.parametrize("v", [1, 3])
    def test_matches_plain_version(self, cuda, fn, g, v):
        n = 1_000_003  # ragged: no multiple of 4, of a block or of a round
        k = _scatter_keys(n, g, v, seed=g + v, cuda=cuda)
        x = torch.from_numpy(np.abs(np.random.default_rng(v).standard_normal(
            (n, v))).astype(np.float32)).to(cuda)
        _check_scatter(fn, k, x, g)

    @pytest.mark.parametrize("fn", [segagg_scatter_cuda, segagg_scatter_atomic_cuda])
    def test_zipf_keys(self, cuda, fn):
        g, n = 360_000, 2_000_001
        k = _scatter_keys(n, g, 1, seed=4, cuda=cuda, zipf=True)
        x = torch.rand((n, 1), generator=torch.Generator().manual_seed(4)).to(cuda)
        _check_scatter(fn, k, x, g)

    @pytest.mark.parametrize("max_ranges, cluster", [(4, 8), (2, 16)])
    def test_forced_ranges(self, cuda, max_ranges, cluster):
        # more ranges than the plan takes: each range's clusters read every row
        g, v = 1_500_000, 1
        smem, _ = scatter_caps(cuda)
        plan = tuning.scatter_plan(g, v, cluster, smem, max_ranges=max_ranges)
        assert plan.route == "cluster" and len(plan.ranges) >= 2
        k = _scatter_keys(700_001, g, v, seed=9, cuda=cuda)
        x = torch.rand((700_001, v), generator=torch.Generator().manual_seed(9)).to(cuda)
        _check_scatter(segagg_scatter_cuda, k, x, g, plan=plan)

    def test_unaligned_views_take_the_element_path(self, cuda):
        g = 360_000
        k = _scatter_keys(500_002, g, 1, seed=5, cuda=cuda)[1:]
        x = torch.rand((500_002, 1), generator=torch.Generator().manual_seed(5)).to(cuda)[1:]
        assert k.data_ptr() % 16 and x.data_ptr() % 16
        _check_scatter(segagg_scatter_cuda, k, x, g)

    def test_empty_and_tiny_inputs(self, cuda):
        for fn in (segagg_scatter_cuda, segagg_scatter_atomic_cuda):
            before = fn.launches
            out = fn(torch.zeros(0, dtype=torch.int32, device=cuda),
                     torch.zeros((0, 3), device=cuda), 360_000)
            assert out.shape == (360_000, 3) and not out.any()
            assert fn.launches == before
            k = torch.tensor([7, -1, 359_999], dtype=torch.int32, device=cuda)
            got = fn(k, torch.ones((3, 1), device=cuda), 360_000)
            assert got.sum().item() == 2.0 and got[7, 0] == 1.0 and got[359_999, 0] == 1.0

    def test_plan_routes_and_counts(self, cuda):
        assert scatter_plan_for(360_000, 1, cuda).route == "cluster"
        assert scatter_plan_for(1_500_000, 1, cuda).route == "atomic"
        keys, vals = _inputs(10_000, 1_500_000, 1, seed=3)
        k, x = torch.from_numpy(keys).to(cuda), torch.from_numpy(vals).to(cuda)
        cluster, atomic = segagg_scatter_cuda.launches, segagg_scatter_atomic_cuda.launches
        segagg_scatter_cuda(k, x, 360_000)
        segagg_scatter_cuda(k, x, 1_500_000)
        assert segagg_scatter_cuda.launches == cluster + 1
        assert segagg_scatter_atomic_cuda.launches == atomic + 1


@pytest.mark.cuda
class TestPaneSegaggOnCard:
    """``pane_segagg`` (composite keys ``pane * G + group``) on the card
    against its plain version, at composite key spaces that take each
    kernel: narrow (TPC-Q6-like's G = 1), the cluster table (one CQ3 pane)
    and the global-atomic scatter (several CQ3 panes)."""

    @pytest.mark.parametrize("panes, g, kernel", [
        (6, 1, segagg_narrow_cuda),
        (1, 360_000, segagg_scatter_cuda),
        (6, 360_000, segagg_scatter_atomic_cuda),
    ])
    def test_matches_plain_version(self, cuda, panes, g, kernel):
        n = 700_001
        rng = np.random.default_rng(panes + g)
        keys = torch.from_numpy(rng.integers(0, g, n).astype(np.int32)).to(cuda)
        pane_ids = torch.from_numpy(np.sort(rng.integers(0, panes, n)).astype(np.int32)).to(cuda)
        vals = torch.from_numpy(rng.random((n, 1)).astype(np.float32)).to(cuda)
        ones = torch.ones_like(vals)
        total = panes * g
        if kernel is segagg_narrow_cuda:
            assert tuning.pick_formulation(total, 1) == "narrow"
        else:
            assert tuning.pick_formulation(total, 1) == "scatter"
            route = "cluster" if kernel is segagg_scatter_cuda else "atomic"
            assert scatter_plan_for(total, 1, cuda).route == route
        before = kernel.launches
        got = ops.pane_segagg(keys, ones, pane_ids, panes, g)
        assert kernel.launches == before + 1
        want = segagg_ref(pane_ids * g + keys, ones, total).reshape(panes, g, 1)
        assert torch.equal(got, want)
        got = ops.pane_segagg(keys, vals, pane_ids, panes, g).double()
        want = segagg_ref(pane_ids * g + keys, vals.double(), total).reshape(panes, g, 1)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# -- flash attention and RG-LRU ----------------------------------------------

from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_cuda,
    flash_attention_sync_cuda,
)
from repro_torch.kernels.flash_attention.ref import chunked_attention_ref  # noqa: E402
from repro_torch.kernels.rglru import ops as rglru_ops  # noqa: E402
from repro_torch.kernels.rglru.ref import rglru_chunked_ref, rglru_ref  # noqa: E402
from repro_torch.kernels.rglru.rglru import rglru_cuda, rglru_serial_cuda  # noqa: E402

# bf16 kernel output against the plain version taken in f32: bf16 rounds
# q, k, v and p (2^-9 relative) and the output.
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _qkv(cuda, B, Sq, Sk, H, Hkv, D, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        (scale * rng.standard_normal(s)).astype(np.float32)).to(cuda)
    return (mk(B, Sq, H, D).bfloat16(), mk(B, Sk, Hkv, D).bfloat16(),
            mk(B, Sk, Hkv, D).bfloat16())


@pytest.mark.cuda
class TestFlashAttentionOnCard:
    @pytest.mark.parametrize("B, S, H, Hkv, D", [
        (2, 128, 4, 4, 64), (1, 200, 8, 2, 128), (2, 333, 16, 1, 256),
        (1, 77, 4, 4, 16), (3, 64, 6, 3, 32), (1, 1000, 2, 1, 96)])
    @pytest.mark.parametrize("causal, window, cap", [
        (True, 0, 0.0), (False, 0, 0.0), (True, 48, 0.0), (True, 0, 50.0),
        (True, 100, 30.0), (False, 64, 0.0)])
    def test_kernel_matches_plain_version(self, cuda, B, S, H, Hkv, D, causal,
                                          window, cap):
        q, k, v = _qkv(cuda, B, S, S, H, Hkv, D, seed=S + D, scale=2.0 if cap else 1.0)
        got = flash_attention_cuda(q, k, v, causal, window, cap)
        want = chunked_attention_ref(q.float(), k.float(), v.float(), causal,
                                     window, cap)
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        torch.testing.assert_close(got.float(), want, **BF16_TOL)

    # The kernel's tile edges: 64-key tiles in a two-stage ring, 64 query
    # rows (D <= 64) or 128 (D 128, 256), warps of 16 rows that skip the
    # tiles none of their rows sees.
    @pytest.mark.parametrize("B, Sq, Sk, H, Hkv, D, causal, window", [
        (1, 100, 100, 4, 1, 256, True, 0),     # keys end inside the second stage
        (2, 150, 197, 6, 3, 64, False, 0),     # Sk != Sq, keys end mid-stage
        (1, 64, 64, 2, 2, 128, True, 0),       # exactly one tile
        (2, 197, 197, 8, 2, 128, True, 100),   # window edge inside a tile, GQA
        (1, 300, 300, 16, 1, 256, True, 65),   # MQA, window one key past a tile
        (1, 130, 130, 4, 4, 64, True, 1),      # window 1: the diagonal only
        (1, 513, 513, 8, 1, 256, False, 200),  # window without the causal mask
        (2, 700, 700, 16, 1, 256, True, 257),  # MQA at D 256, tiles skipped by warps
    ])
    def test_tile_edges(self, cuda, B, Sq, Sk, H, Hkv, D, causal, window):
        q, k, v = _qkv(cuda, B, Sq, Sk, H, Hkv, D, seed=Sq + Sk + window)
        want = chunked_attention_ref(q.float(), k.float(), v.float(), causal, window)
        got = flash_attention_cuda(q, k, v, causal, window)
        torch.testing.assert_close(got.float(), want, **BF16_TOL)

    @pytest.mark.parametrize("B, S, H, Hkv, D, window", [
        (1, 333, 16, 1, 256, 100), (2, 200, 8, 2, 128, 0)])
    def test_earlier_kernel_matches_plain_version(self, cuda, B, S, H, Hkv, D, window):
        """The earlier kernel, kept as a yardstick, computes the same function."""
        q, k, v = _qkv(cuda, B, S, S, H, Hkv, D, seed=S)
        want = chunked_attention_ref(q.float(), k.float(), v.float(), True, window)
        got = flash_attention_sync_cuda(q, k, v, True, window)
        torch.testing.assert_close(got.float(), want, **BF16_TOL)

    def test_reads_strided_layouts(self, cuda):
        # q, k, v as column slices of one fused projection: not contiguous.
        B, S, H, D = 2, 130, 4, 64
        qkv = torch.randn(B, S, 3 * H, D, device=cuda).bfloat16()
        q, k, v = qkv[:, :, :H], qkv[:, :, H:2 * H], qkv[:, :, 2 * H:]
        got = flash_attention_cuda(q, k, v, True, 0, 0.0)
        want = chunked_attention_ref(q.float(), k.float(), v.float(), True)
        torch.testing.assert_close(got.float(), want, **BF16_TOL)

    def test_refusals(self, cuda):
        q, k, v = _qkv(cuda, 1, 32, 32, 4, 2, 64, seed=0)
        before = flash_attention_cuda.launches
        with pytest.raises(TypeError, match="bfloat16"):
            flash_attention_cuda(q.float(), k.float(), v.float())
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention_cuda(q.cpu(), k.cpu(), v.cpu())
        with pytest.raises(ValueError, match="contiguous head dim"):
            flash_attention_cuda(q.transpose(1, 3).contiguous().transpose(1, 3), k, v)
        with pytest.raises(ValueError, match="head dim"):
            flash_attention_cuda(*_qkv(cuda, 1, 8, 8, 2, 2, 264, seed=1))
        with pytest.raises(NotImplementedError, match="q_offset"):
            flash_ops.flash_attention(q, k, v, q_offset=3)
        with pytest.raises(NotImplementedError, match="kv_valid_len"):
            flash_ops.flash_attention(q, k, v, kv_valid_len=torch.ones(1, device=cuda))
        assert flash_attention_cuda.launches == before
        flash_ops.flash_attention(q, k, v, True, 16)
        assert flash_attention_cuda.launches == before + 1


@pytest.mark.cuda
class TestRGLRUOnCard:
    # S not a multiple of the 128-step chunk, N not of the 32-channel tile.
    @pytest.mark.parametrize("B, S, N", [(1, 257, 130), (8, 100, 4096), (2, 7, 33),
                                         (1, 1000, 4096), (1, 4100, 4072), (1, 128, 4096)])
    @pytest.mark.parametrize("with_h0", [False, True])
    def test_kernel_matches_plain_version(self, cuda, B, S, N, with_h0):
        rng = np.random.default_rng(B * S + N)
        f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)  # noqa: E731
        x, r, i = f(B, S, N), torch.sigmoid(f(B, S, N)), torch.sigmoid(f(B, S, N))
        a_param, h0 = f(N), (f(B, N) if with_h0 else None)
        y32, h32 = rglru_cuda(x, r, i, a_param, h0)
        y_ref, h_ref = rglru_ref(x, r, i, a_param, h0)
        torch.testing.assert_close(y32, y_ref, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(h32, h_ref, rtol=2e-4, atol=2e-4)
        xb, rb, ib = x.bfloat16(), r.bfloat16(), i.bfloat16()
        yb, hb = rglru_cuda(xb, rb, ib, a_param, h0)
        y_ref, h_ref = rglru_ref(xb.float(), rb.float(), ib.float(), a_param, h0)
        assert yb.dtype == torch.bfloat16 and hb.dtype == torch.float32
        torch.testing.assert_close(yb.float(), y_ref, **BF16_TOL)
        torch.testing.assert_close(hb, h_ref, rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("B, S, N", [(1, 1000, 4096), (2, 300, 100)])
    def test_kernel_follows_its_order_of_arithmetic(self, cuda, B, S, N):
        """f32: the kernel against ``rglru_chunked_ref`` (the same sub-segment
        scans and carry combine) within 2e-5, the f32 kernel tolerance;
        they differ only in expf against torch.exp and fused multiply-adds."""
        rng = np.random.default_rng(S + N)
        f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)  # noqa: E731
        x, r, i = f(B, S, N), torch.sigmoid(f(B, S, N)), torch.sigmoid(f(B, S, N))
        a_param, h0 = f(N), f(B, N)
        y, h = rglru_cuda(x, r, i, a_param, h0)
        y_ref, h_ref = rglru_chunked_ref(x, r, i, a_param, h0)
        torch.testing.assert_close(y, y_ref, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(h, h_ref, rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_earlier_kernel_matches_plain_version(self, cuda, dtype):
        """The earlier kernel, kept as a yardstick, computes the same function."""
        rng = np.random.default_rng(9)
        f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)  # noqa: E731
        x, r, i = f(2, 300, 100), torch.sigmoid(f(2, 300, 100)), torch.sigmoid(f(2, 300, 100))
        a_param, h0 = f(100), f(2, 100)
        xd, rd, id_ = x.to(dtype), r.to(dtype), i.to(dtype)
        y, h = rglru_serial_cuda(xd, rd, id_, a_param, h0)
        y_ref, h_ref = rglru_ref(xd.float(), rd.float(), id_.float(), a_param, h0)
        tol = BF16_TOL if dtype == torch.bfloat16 else dict(rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(y.float(), y_ref, **tol)
        torch.testing.assert_close(h, h_ref, rtol=2e-4, atol=2e-4)

    def test_refusals(self, cuda):
        x = torch.rand(2, 5, 8, device=cuda)
        a = torch.zeros(8, device=cuda)
        before = rglru_cuda.launches
        with pytest.raises(TypeError, match="dtype"):
            rglru_cuda(x.half(), x.half(), x.half(), a)
        with pytest.raises(TypeError, match="float32"):
            rglru_cuda(x, x, x, a.bfloat16())
        with pytest.raises(ValueError, match="CUDA"):
            rglru_cuda(x.cpu(), x.cpu(), x.cpu(), a.cpu())
        with pytest.raises(ValueError, match="contiguous"):
            rglru_cuda(x.transpose(0, 1).contiguous().transpose(0, 1), x, x, a)
        with pytest.raises(ValueError, match="a_param"):
            rglru_cuda(x, x, x, a[:4])
        assert rglru_cuda.launches == before
        rglru_ops.rglru(x.bfloat16(), x.bfloat16(), x.bfloat16(), a.bfloat16())
        assert rglru_cuda.launches == before + 1


# -- Mamba-2 SSD ---------------------------------------------------------------

from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_chunked_bf16ops_ref, ssd_chunked_ref  # noqa: E402
from repro_torch.kernels.ssd.ssd import ssd_cuda  # noqa: E402

# The JAX package's SSD tolerances (tests/test_kernels.py TestSSD): y 2e-4 in
# f32 and 3e-2 in bf16 (one rounding of y; the inputs are the same bf16
# values on both sides); h_last rtol 2e-3 with atol 2e-3 (f32) or 5e-3 (bf16).
SSD_Y_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
SSD_H_ATOL = {torch.float32: 2e-3, torch.bfloat16: 5e-3}
# The bf16 kernel against the plain version of its own arithmetic
# (ssd_chunked_bf16ops_ref: the same operands split into bf16 parts): y
# within 1e-2, a third of the bf16 tolerance.
SSD_BF16OPS_Y_TOL = 1e-2
# mamba2's (H 32, P 64, N 128) at B = 1, 2 and 8 runs P-tiles of 16, 32 and
# 64 columns; S = 129 is one chunk and one step, so the last chunk is a
# single row (one strip, one s-tile of the triangle).
SSD_SHAPES = [(1, 1000, 32, 64, 128), (2, 300, 32, 64, 128), (8, 512, 32, 64, 128),
              (1, 256, 2, 16, 8), (2, 200, 4, 32, 16), (8, 77, 3, 40, 5),
              (2, 129, 32, 64, 128)]


def _ssd_inputs(cuda, B, S, H, P, N, dtype, shared, with_h0, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)  # noqa: E731
    x = (0.5 * f(B, S, H, P)).to(dtype)
    dt = torch.nn.functional.softplus(f(B, S, H)).to(dtype)
    A = -f(H).abs() - 0.1
    if shared:
        Bm = (0.3 * f(B, S, N)).to(dtype)[:, :, None].expand(B, S, H, N)
        Cm = (0.3 * f(B, S, N)).to(dtype)[:, :, None].expand(B, S, H, N)
    else:
        Bm, Cm = (0.3 * f(B, S, H, N)).to(dtype), (0.3 * f(B, S, H, N)).to(dtype)
    return x, dt, A, Bm, Cm, f(H), (f(B, H, N, P) if with_h0 else None)


@pytest.mark.cuda
class TestSSDOnCard:
    # f32 runs the CUDA-core kernel (2e-4 is beyond bf16 products), bf16 the
    # tensor-core one.
    @pytest.mark.parametrize("B, S, H, P, N", SSD_SHAPES)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("shared", [True, False])
    @pytest.mark.parametrize("with_h0", [False, True])
    def test_kernel_matches_plain_version(self, cuda, B, S, H, P, N, dtype, shared,
                                          with_h0):
        x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(cuda, B, S, H, P, N, dtype, shared,
                                              with_h0, seed=B * S + N)
        y, h = ssd_cuda(x, dt, A, Bm, Cm, D, h0)
        y_ref, h_ref = ssd_chunked_ref(x.float(), dt.float(), A, Bm.float(), Cm.float(),
                                       D, 128, h0)
        assert y.dtype == dtype and h.dtype == torch.float32
        tol = SSD_Y_TOL[dtype]
        torch.testing.assert_close(y.float(), y_ref, rtol=tol, atol=tol)
        torch.testing.assert_close(h, h_ref, rtol=2e-3, atol=SSD_H_ATOL[dtype])

    @pytest.mark.parametrize("B, S, H, P, N", SSD_SHAPES)
    @pytest.mark.parametrize("shared", [True, False])
    @pytest.mark.parametrize("with_h0", [False, True])
    def test_bf16_kernel_matches_its_arithmetic(self, cuda, B, S, H, P, N, shared, with_h0):
        x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(cuda, B, S, H, P, N, torch.bfloat16, shared,
                                              with_h0, seed=B * S + N + 1)
        y, h = ssd_cuda(x, dt, A, Bm, Cm, D, h0)
        y_ref, h_ref = ssd_chunked_bf16ops_ref(x, dt, A, Bm, Cm, D, 128, h0)
        tol = SSD_BF16OPS_Y_TOL
        torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(h, h_ref, rtol=2e-3, atol=SSD_H_ATOL[torch.bfloat16])

    def test_stride0_b_and_c_equal_materialised(self, cuda):
        a = _ssd_inputs(cuda, 2, 300, 8, 64, 128, torch.bfloat16, True, True, seed=1)
        y_v, h_v = ssd_cuda(*a)
        y_m, h_m = ssd_cuda(a[0], a[1], a[2], a[3].contiguous(), a[4].contiguous(), a[5],
                            a[6])
        assert torch.equal(y_v, y_m) and torch.equal(h_v, h_m)

    def test_ops_on_card_launches_the_kernel_only(self, cuda, monkeypatch):
        x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(cuda, 1, 130, 4, 16, 8, torch.bfloat16,
                                              True, True, seed=2)
        monkeypatch.setattr(ssd_ops, "ssd_chunked_ref", None)  # never called on the card
        before = ssd_cuda.launches
        y, h = ssd_ops.ssd(x, dt, A.bfloat16(), Bm, Cm, D.bfloat16(), h0, chunk=16)
        assert ssd_cuda.launches == before + 1
        assert y.shape == x.shape and h.shape == (1, 4, 8, 16)

    def test_refusals(self, cuda):
        x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(cuda, 2, 40, 4, 16, 8, torch.float32,
                                              False, True, seed=3)
        before = ssd_cuda.launches
        with pytest.raises(ValueError, match="CUDA"):
            ssd_cuda(*(t.cpu() for t in (x, dt, A, Bm, Cm, D, h0)))
        with pytest.raises(TypeError, match="dtype"):
            ssd_cuda(x.half(), dt.half(), A, Bm.half(), Cm.half(), D, h0)
        with pytest.raises(TypeError, match="float32"):
            ssd_cuda(x, dt, A.bfloat16(), Bm, Cm, D, h0)
        with pytest.raises(ValueError, match="contiguous"):
            ssd_cuda(x.transpose(0, 1).contiguous().transpose(0, 1), dt, A, Bm, Cm, D, h0)
        with pytest.raises(ValueError, match="h0"):
            ssd_cuda(x, dt, A, Bm, Cm, D, h0[:, :, :4])
        with pytest.raises(ValueError, match="state size"):
            ssd_cuda(x, dt, A, *(torch.zeros(2, 40, 4, 129, device=cuda),) * 2, D)
        assert ssd_cuda.launches == before
