"""The two Hopper segagg kernels against their plain PyTorch version, on
the card.  Marked ``cuda``: they skip without a CUDA card (the kernels have
no CPU mode).  This file imports no JAX, so it runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.segagg import ops, tuning
from repro_torch.kernels.segagg.ref import segagg_ref, zipf_keys
from repro_torch.kernels.segagg.segagg import (
    NARROW_TABLE_BYTES,
    narrow_work,
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


@pytest.fixture
def untuned(monkeypatch, tmp_path):
    """The compiled-in defaults in force (no tuned table), for tests that
    name the route a shape takes."""
    monkeypatch.setattr(tuning, "TUNED_PATH", tmp_path / "none.json")
    tuning.reload()
    yield
    tuning.reload()


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

    def test_ops_on_card_launches_a_kernel(self, cuda, untuned):
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
    ranges = (scatter_plan_for(g, v, cuda, n=n).ranges
              + scatter_plan_for(g, v, cuda, n=n, max_ranges=4).ranges)
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

    def test_plan_routes_and_counts(self, cuda, untuned):
        assert scatter_plan_for(360_000, 1, cuda, n=10_000).route == "cluster"
        assert scatter_plan_for(1_500_000, 1, cuda, n=10_000).route == "atomic"
        keys, vals = _inputs(10_000, 1_500_000, 1, seed=3)
        k, x = torch.from_numpy(keys).to(cuda), torch.from_numpy(vals).to(cuda)
        cluster, atomic = segagg_scatter_cuda.launches, segagg_scatter_atomic_cuda.launches
        segagg_scatter_cuda(k, x, 360_000)
        segagg_scatter_cuda(k, x, 1_500_000)
        assert segagg_scatter_cuda.launches == cluster + 1
        assert segagg_scatter_atomic_cuda.launches == atomic + 1


def _narrow_inputs(n, g, v, seed, cuda, first=0):
    """Rows ``first`` .. ``first + n`` of longer keys (uniform in [0, g), 1%
    of them outside on either side, negative ones included) and |values|."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, g, n + 4).astype(np.int32)
    bad = rng.random(n + 4) < 0.01
    keys[bad] = rng.choice([-1, -(g + 1), g, g + 7, -(2**31), 2**31 - 1], bad.sum())
    vals = np.abs(rng.standard_normal((n + 4, v))).astype(np.float32)
    k, x = torch.from_numpy(keys).to(cuda), torch.from_numpy(vals).to(cuda)
    return k[first:first + n], x[first:first + n]


def _check_narrow(k, x, g):
    ones = torch.ones_like(x)
    assert torch.equal(segagg_narrow_cuda(k, ones, g), segagg_ref(k, ones, g))
    torch.testing.assert_close(segagg_narrow_cuda(k, x, g).double(),
                               segagg_ref(k, x.double(), g), rtol=1e-4, atol=1e-4)
    assert not narrow_work(k.device).any()  # the last block leaves it zero


@pytest.mark.cuda
class TestNarrowOnCard:
    """The narrow kernel's paths against the plain version (counts by
    ``torch.equal``, |values| sums within 1e-4): register slots (G*V <= 32)
    and the shared table up to ``NARROW_TABLE_BYTES``; the vector path from
    a 16-byte boundary or from row 1 (three head rows), the element path at
    V = 3 and for keys and values at different offsets; ragged and tiny N."""

    @pytest.mark.parametrize("g, v", [(g, v) for g in (1, 5, 32, 33, 2048, 12288)
                                      for v in (1, 3) if g * v * 4 <= NARROW_TABLE_BYTES])
    @pytest.mark.parametrize("first", [0, 1])
    def test_matches_plain_version(self, cuda, g, v, first):
        k, x = _narrow_inputs(1_000_003, g, v, seed=g + v + first, cuda=cuda, first=first)
        _check_narrow(k, x, g)

    @pytest.mark.parametrize("g", [1, 5, 33])
    def test_keys_and_values_at_different_offsets(self, cuda, g):
        k, _ = _narrow_inputs(700_001, g, 1, seed=g, cuda=cuda, first=1)
        _, x = _narrow_inputs(700_001, g, 1, seed=g + 1, cuda=cuda)
        assert k.data_ptr() % 16 != x.data_ptr() % 16
        _check_narrow(k, x, g)

    @pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7])
    @pytest.mark.parametrize("first", [0, 1, 2, 3])
    def test_tiny_inputs(self, cuda, n, first):
        for g, v in ((1, 1), (5, 1), (5, 3), (33, 1)):
            k, x = _narrow_inputs(n, g, v, seed=n + first, cuda=cuda, first=first)
            _check_narrow(k, x, g)

    def test_one_launch_a_call(self, cuda):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        k, x = _narrow_inputs(100_003, 5, 1, seed=8, cuda=cuda)
        segagg_narrow_cuda(k, x, 5)  # the stream's workspace exists
        torch.cuda.synchronize()
        before = segagg_narrow_cuda.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            segagg_narrow_cuda(k, x, 5)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        assert len(names) == 1 and "segagg_narrow" in names[0], names
        assert segagg_narrow_cuda.launches == before + 1

    def test_two_streams_keep_their_own_workspace(self, cuda):
        k, x = _narrow_inputs(2_000_003, 2048, 1, seed=6, cuda=cuda)
        want = segagg_ref(k, x.double(), 2048)
        streams = [torch.cuda.Stream(cuda) for _ in range(2)]
        outs = []
        torch.cuda.synchronize()
        for s in streams:
            with torch.cuda.stream(s):
                outs.append([segagg_narrow_cuda(k, x, 2048) for _ in range(3)])
        torch.cuda.synchronize()
        works = []
        for s in streams:
            with torch.cuda.stream(s):
                works.append(narrow_work(cuda))
        assert works[0].data_ptr() != works[1].data_ptr()
        for got in (o for row in outs for o in row):
            torch.testing.assert_close(got.double(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.usefixtures("untuned")
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
            assert tuning.pick_formulation("cuda", n, total, 1) == "narrow"
        else:
            assert tuning.pick_formulation("cuda", n, total, 1) == "scatter"
            route = "cluster" if kernel is segagg_scatter_cuda else "atomic"
            assert scatter_plan_for(total, 1, cuda, n=n).route == route
        before = kernel.launches
        got = ops.pane_segagg(keys, ones, pane_ids, panes, g)
        assert kernel.launches == before + 1
        want = segagg_ref(pane_ids * g + keys, ones, total).reshape(panes, g, 1)
        assert torch.equal(got, want)
        got = ops.pane_segagg(keys, vals, pane_ids, panes, g).double()
        want = segagg_ref(pane_ids * g + keys, vals.double(), total).reshape(panes, g, 1)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
class TestTunedDispatchOnCard:
    """``ops.segagg`` with the table in force (``tuning.TUNED_PATH``): at
    ``matmul_max_g("cuda")`` it launches the narrow kernel, one past it a
    scatter kernel; each forced formulation gives the plain version's
    counts, and a forced ``"matmul"`` that does not fit launches nothing."""

    N = 200_003

    def _keys(self, cuda, g):
        keys, _ = _inputs(self.N, g, 1, seed=g)
        return torch.from_numpy(keys).to(cuda), torch.ones((self.N, 1), device=cuda)

    @staticmethod
    def _launches():
        return (segagg_narrow_cuda.launches,
                segagg_scatter_cuda.launches + segagg_scatter_atomic_cuda.launches)

    def test_boundary_launches_narrow_then_scatter(self, cuda):
        m = tuning.matmul_max_g("cuda")
        for g, launched in ((m, (1, 0)), (m + 1, (0, 1))):
            if g < 1:
                continue
            k, ones = self._keys(cuda, g)
            before = self._launches()
            got = ops.segagg(k, ones, g)
            assert tuple(a - b for a, b in zip(self._launches(), before)) == launched
            assert torch.equal(got, segagg_ref(k, ones, g))

    @pytest.mark.parametrize("form, launched", [("matmul", (1, 0)), ("scatter", (0, 1))])
    @pytest.mark.parametrize("g", [1, 5, 2048, 12288])
    def test_forced_formulation(self, cuda, form, launched, g):
        k, ones = self._keys(cuda, g)
        before = self._launches()
        got = ops.segagg(k, ones, g, formulation=form)
        assert tuple(a - b for a, b in zip(self._launches(), before)) == launched
        assert torch.equal(got, segagg_ref(k, ones, g))

    @pytest.mark.parametrize("n", [13_000, 26_000, 100_003])
    def test_scatter_takes_the_tuned_plan(self, cuda, n):
        g = 360_000  # CQ3's groups: small-wide, then large-wide
        cluster, _ = tuning.tuned_blocks("cuda", n, g)
        plan = scatter_plan_for(g, 1, cuda, n=n)
        assert plan.route == "cluster"
        assert plan.cluster == min(cluster, scatter_caps(cuda)[1])
        k, ones = self._keys(cuda, g)
        k, ones = k[:n], ones[:n]
        before = self._launches()
        got = ops.segagg(k, ones, g)
        assert tuple(a - b for a, b in zip(self._launches(), before)) == (0, 1)
        assert torch.equal(got, segagg_ref(k, ones, g))

    def test_forced_matmul_that_does_not_fit_launches_nothing(self, cuda):
        k, ones = self._keys(cuda, 12289)
        before = self._launches()
        with pytest.raises(ValueError, match="formulation='matmul'"):
            ops.segagg(k, ones, 12289, formulation="matmul")
        assert self._launches() == before


@pytest.mark.cuda
@pytest.mark.usefixtures("untuned")
class TestDeviceMeshOnCard:
    """``DeviceMesh(["cuda:0"] * 2)``: two shards of one card, each on its
    slot's stream, merged on the card; one launch of the route's kernel a
    shard, against the plain version.  Run twice, so a partial freed or
    reused before the merge read it would show as a wrong sum."""

    @pytest.mark.parametrize("g, kernel", [
        (5, segagg_narrow_cuda),
        (360_000, segagg_scatter_cuda),
        (1_500_000, segagg_scatter_atomic_cuda),
    ])
    @pytest.mark.parametrize("n", [1, 1_000_001])
    def test_two_slots_on_one_card(self, cuda, g, kernel, n):
        from repro_torch.dist import DeviceMesh

        mesh = DeviceMesh(["cuda:0"] * 2)
        keys, vals = _inputs(n, g, 1, seed=g + n)
        k, x = torch.from_numpy(keys), torch.from_numpy(np.abs(vals))
        ones = torch.ones_like(x)
        want = segagg_ref(k, ones, g).to(cuda)
        for _ in range(2):
            before = kernel.launches
            got = mesh.segagg(keys, np.ones_like(vals), g)
            assert kernel.launches == before + 2
            assert got.device == torch.device("cuda", 0)
            assert torch.equal(got, want)
        got = mesh.segagg(k.to(cuda), x.to(cuda), g).double()
        torch.testing.assert_close(got, segagg_ref(k, x.double(), g).to(cuda),
                                   rtol=1e-4, atol=1e-4)

    def test_one_slot_is_the_single_device_op(self, cuda):
        from repro_torch.dist import DeviceMesh

        keys, vals = _inputs(100_003, 360_000, 1, seed=4)
        before = segagg_scatter_cuda.launches
        got = DeviceMesh(["cuda:0"]).segagg(keys, np.ones_like(vals), 360_000)
        assert segagg_scatter_cuda.launches == before + 1
        k = torch.from_numpy(keys)
        assert torch.equal(got.cpu(), segagg_ref(k, torch.ones((k.shape[0], 1)), 360_000))


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: the merge across cards "
                    f"(torch sees {torch.cuda.device_count()})")
    return cuda


@pytest.mark.cuda
@pytest.mark.usefixtures("untuned")
class TestDeviceMeshAcrossCards:
    """``DeviceMesh(2)``: a shard on each of two cards, on its slot's
    stream, the partial moved to the first card and merged there, against
    the one-card op on the first card (counts exact, float sums within
    1e-4).  Run twice, so a partial freed or reused before the merge read
    it would show as a wrong sum."""

    @pytest.mark.parametrize("g, kernel", [
        (5, segagg_narrow_cuda),
        (360_000, segagg_scatter_cuda),
        (1_500_000, segagg_scatter_atomic_cuda),
    ])
    @pytest.mark.parametrize("n", [1, 1_000_001])
    def test_segagg_on_two_cards(self, two_cards, g, kernel, n):
        from repro_torch.dist import DeviceMesh

        mesh = DeviceMesh(2)
        card0 = torch.device("cuda", 0)
        keys, vals = _inputs(n, g, 1, seed=g + n)
        k, x = torch.from_numpy(keys), torch.from_numpy(np.abs(vals))
        ones = torch.ones_like(x)
        want = ops.segagg(k.to(card0), ones.to(card0), g)
        for _ in range(2):
            before = kernel.launches
            got = mesh.segagg(keys, np.ones_like(vals), g)
            assert kernel.launches == before + 2
            assert got.device == card0
            assert torch.equal(got, want)
        for src in (card0, torch.device("cuda", 1)):  # inputs already on a card
            got = mesh.segagg(k.to(src), x.to(src), g)
            assert got.device == card0
            torch.testing.assert_close(got, ops.segagg(k.to(card0), x.to(card0), g),
                                       rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("panes, g", [(6, 5), (6, 360_000)])
    def test_pane_segagg_on_two_cards(self, two_cards, panes, g):
        from repro_torch.dist import DeviceMesh

        card0 = torch.device("cuda", 0)
        keys, vals = _inputs(1_000_001, g, 1, seed=panes + g)
        pane_ids = np.random.default_rng(g).integers(0, panes, keys.shape[0]).astype(np.int32)
        k, x, p = (torch.from_numpy(keys), torch.from_numpy(np.abs(vals)),
                   torch.from_numpy(pane_ids))
        got = DeviceMesh(2).pane_segagg(keys, np.ones_like(vals), pane_ids, panes, g)
        want = ops.pane_segagg(k.to(card0), torch.ones_like(x).to(card0), p.to(card0),
                               panes, g)
        assert got.device == card0 and torch.equal(got, want)
        got = DeviceMesh(2).pane_segagg(k, x, p, panes, g)
        torch.testing.assert_close(got, ops.pane_segagg(k.to(card0), x.to(card0),
                                                        p.to(card0), panes, g),
                                   rtol=1e-4, atol=1e-4)


# -- flash attention and RG-LRU ----------------------------------------------

from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_cuda,
    flash_attention_sync_cuda,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    chunked_attention_f32_ref,
    chunked_attention_ref,
    rows_with_keys,
)
from repro_torch.kernels.rglru import ops as rglru_ops  # noqa: E402
from repro_torch.kernels.rglru.ref import rglru_chunked_ref, rglru_ref  # noqa: E402
from repro_torch.kernels.rglru.rglru import rglru_cuda, rglru_serial_cuda  # noqa: E402

# bf16 kernel output against the plain version taken in f32: bf16 rounds
# q, k, v and p (2^-9 relative) and the output.  The flash kernel rounds
# q/sqrt(D) to bf16 as the JAX layer does, so its reference
# (chunked_attention_f32_ref) rounds q the same way and keeps k, v and p in
# f32; the earlier kernel, which scales the product, is held against the
# plain version on inputs widened to f32.
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
        want = chunked_attention_f32_ref(q, k, v, causal, window, cap)
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
        want = chunked_attention_f32_ref(q, k, v, causal, window)
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
        want = chunked_attention_f32_ref(q, k, v, True)
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
        with pytest.raises(ValueError, match="q_offset"):
            flash_ops.flash_attention(q, k, v, q_offset=-1)
        with pytest.raises(ValueError, match="kv_valid_len"):
            flash_ops.flash_attention(q, k, v, kv_valid_len=torch.ones(2, device=cuda))
        assert flash_attention_cuda.launches == before
        flash_ops.flash_attention(q, k, v, True, 16)
        assert flash_attention_cuda.launches == before + 1

    # Prefill continuation (query row i at position q_offset + i) and ragged
    # valid lengths (keys at or past kv_valid_len[b] masked): the rows that
    # see a key against the plain version, the rows that see none zero (the
    # plain version gives them a softmax over masked keys).
    @pytest.mark.parametrize("B, Sq, Sk, H, Hkv, D, causal, window", [
        (2, 100, 300, 8, 2, 128, True, 0),       # GQA, continuation
        (3, 64, 700, 16, 1, 256, True, 257),     # MQA at D 256, window
        (2, 1, 513, 4, 4, 64, True, 0),          # one decode token
        (2, 130, 130, 4, 2, 128, False, 0),      # not causal: valid lengths only
        (1, 200, 1000, 16, 1, 256, True, 128),   # window ends inside the new rows
        (2, 77, 141, 6, 3, 32, True, 40)])       # ragged everywhere
    @pytest.mark.parametrize("ragged", [False, True])
    def test_offset_and_valid_length(self, cuda, B, Sq, Sk, H, Hkv, D, causal, window,
                                     ragged):
        q, k, v = _qkv(cuda, B, Sq, Sk, H, Hkv, D, seed=Sq + Sk + window)
        rng = np.random.default_rng(Sk)
        valid = (torch.from_numpy(rng.integers(1, Sk + 1, B).astype(np.int32)).to(cuda)
                 if ragged else None)
        off = Sk - Sq
        before = flash_attention_cuda.launches
        got = flash_ops.flash_attention(q, k, v, causal, window, q_offset=off,
                                        kv_valid_len=valid)
        assert flash_attention_cuda.launches == before + 1
        want = chunked_attention_f32_ref(q, k, v, causal, window, q_offset=off,
                                         kv_valid_len=valid)
        live = rows_with_keys(B, Sq, Sk, causal, window, off, valid, device=cuda)
        assert not got[~live].any()
        torch.testing.assert_close(got[live].float(), want[live], **BF16_TOL)

    # whisper-medium's shapes (16 heads of 64, not causal): the encoder's
    # 1,500 frames (23 full 64-key tiles and one of 28) and the decoder's
    # cross-attention, 224 queries to them.
    @pytest.mark.parametrize("B, Sq, Sk", [(2, 1500, 1500), (2, 224, 1500)])
    def test_whisper_shapes(self, cuda, B, Sq, Sk):
        q, k, v = _qkv(cuda, B, Sq, Sk, 16, 16, 64, seed=Sq)
        before = flash_attention_cuda.launches
        got = flash_ops.flash_attention(q, k, v, causal=False)
        assert flash_attention_cuda.launches == before + 1
        want = chunked_attention_f32_ref(q, k, v, False)
        torch.testing.assert_close(got.float(), want, **BF16_TOL)

    def test_valid_length_zero_gives_zeros(self, cuda):
        q, k, v = _qkv(cuda, 2, 40, 90, 4, 2, 64, seed=3)
        valid = torch.tensor([0, 90], dtype=torch.int32, device=cuda)
        got = flash_attention_cuda(q, k, v, True, 0, 0.0, 50, valid)
        assert not got[0].any()
        want = chunked_attention_f32_ref(q[1:], k[1:], v[1:], True, q_offset=50)
        torch.testing.assert_close(got[1:].float(), want, **BF16_TOL)


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


# -- decode --------------------------------------------------------------------

from repro_torch.models import lm as torch_lm  # noqa: E402
from repro_torch.models.base import get_config  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).norm() / want.norm()).item()


@pytest.mark.cuda
class TestDecodeOnCard:
    # Reduced configs, the same seeded bf16 weights on the card and on the
    # CPU: the prefill (the kernels on the card, their plain versions on the
    # CPU) and six decode steps (plain ops on both) within a relative L2
    # error of 5e-2, the smoke's bar (bf16 rounds at other places in the
    # kernels than in the plain versions).  recurrentgemma's ring of 16
    # wraps; the steps launch no kernel.
    @pytest.mark.parametrize("arch", ["recurrentgemma_9b", "mamba2_370m", "olmoe_1b_7b",
                                      "yi_6b"])
    def test_decode_step_matches_cpu(self, cuda, arch):
        cfg = get_config(arch).reduced()
        params = init_params(torch_lm.build_specs(cfg), seed=1, device="cpu")
        on_card = {k: v.to(cuda) for k, v in params.items()}
        S, n = 24, 6
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, S + n)).astype(np.int32))
        want, cache_cpu, clen = torch_lm.prefill(cfg, params, toks[:, :S], S + n)
        got, cache_card, _ = torch_lm.prefill(cfg, on_card, toks[:, :S].to(cuda), S + n)
        assert _rel_l2(got, want) < 5e-2
        kernels = (flash_attention_cuda, rglru_cuda, ssd_cuda)
        before = [k.launches for k in kernels]
        for t in range(n):
            step = toks[:, S + t:S + t + 1]
            want, cache_cpu = torch_lm.decode_step(cfg, params, cache_cpu, clen + t, step)
            got, cache_card = torch_lm.decode_step(cfg, on_card, cache_card, clen + t,
                                                   step.to(cuda))
            assert got.is_cuda and got.shape == (2, 1, cfg.vocab_size)
            assert _rel_l2(got, want) < 5e-2, t
        assert [k.launches for k in kernels] == before


from repro_torch.models import encdec as torch_encdec  # noqa: E402
from repro_torch.models.config import uniform  # noqa: E402


@pytest.mark.cuda
class TestWhisperOnCard:
    # whisper-medium at full width cut to 2 encoder and 2 decoder layers, the
    # same seeded bf16 weights on the card and on the CPU: the encoder's
    # output (the flash kernel on the card, two launches; its plain version
    # on the CPU), then the decoder's prefill on the same encoder output (four
    # launches: self- and cross-attention), each within a relative L2 error
    # of 5e-2, the smoke's bar.  The seeded cross-attention is nearly one-hot
    # (scores of rms ~64), so the encoder's bf16 differences reorder
    # near-tied frames: end to end, two plain paths that differ in rounding
    # only part as far (PERF.md).
    def test_encdec_prefill_matches_cpu(self, cuda):
        cfg = get_config("whisper_medium")
        cfg = dataclasses.replace(cfg, segments=uniform("xattn", 2),
                                  encoder_segments=uniform("attn", 2))
        params = init_params(torch_encdec.build_encdec_specs(cfg), seed=1, device="cpu")
        on_card = {k: v.to(cuda) for k, v in params.items()}
        rng = np.random.default_rng(1)
        frames = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).bfloat16()
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32))
        before = flash_attention_cuda.launches
        enc_cpu = torch_encdec.encode(cfg, params, frames)
        enc_card = torch_encdec.encode(cfg, on_card, frames.to(cuda))
        assert flash_attention_cuda.launches == before + 2
        assert _rel_l2(enc_card, enc_cpu) < 5e-2
        want, _, _ = torch_lm.prefill(cfg, params, toks, 36, enc_out=enc_cpu)
        got, cache, _ = torch_lm.prefill(cfg, on_card, toks.to(cuda), 36,
                                         enc_out=enc_cpu.to(cuda))
        assert flash_attention_cuda.launches == before + 6
        assert got.shape == (2, cfg.vocab_size) and torch.isfinite(got).all()
        assert cache["seg0/l0/xk"].shape == (2, 2, cfg.encoder_seq, 16, 64)
        assert _rel_l2(got, want) < 5e-2

    # The reduced config (24 frames, 4 heads of 16) as TestDecodeOnCard
    # runs the others: encdec_prefill and six decode steps that read the
    # cached cross-attention K/V, card against CPU within 5e-2; the steps
    # launch no kernel.
    def test_decode_step_matches_cpu(self, cuda):
        cfg = get_config("whisper_medium").reduced()
        params = init_params(torch_encdec.build_encdec_specs(cfg), seed=1, device="cpu")
        on_card = {k: v.to(cuda) for k, v in params.items()}
        rng = np.random.default_rng(2)
        frames = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).bfloat16()
        S, n = 24, 6
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S + n)).astype(np.int32))
        want, cache_cpu, clen, _ = torch_encdec.encdec_prefill(cfg, params, frames,
                                                               toks[:, :S], S + n)
        got, cache_card, _, _ = torch_encdec.encdec_prefill(cfg, on_card, frames.to(cuda),
                                                            toks[:, :S].to(cuda), S + n)
        assert _rel_l2(got, want) < 5e-2
        before = flash_attention_cuda.launches
        for t in range(n):
            step = toks[:, S + t:S + t + 1]
            want, cache_cpu = torch_encdec.encdec_decode_step(cfg, params, cache_cpu,
                                                              clen + t, step)
            got, cache_card = torch_encdec.encdec_decode_step(cfg, on_card, cache_card,
                                                              clen + t, step.to(cuda))
            assert got.is_cuda and got.shape == (2, 1, cfg.vocab_size)
            assert _rel_l2(got, want) < 5e-2, t
        assert flash_attention_cuda.launches == before


from repro_torch.kernels.rglru.ref import rglru_bwd_ref  # noqa: E402
from repro_torch.kernels.rglru.rglru import rglru_bwd_cuda  # noqa: E402
from repro_torch.layers import attention as torch_attention  # noqa: E402
from repro_torch.layers.ssd import ssd_bwd  # noqa: E402
from repro_torch.models.config import patterned  # noqa: E402
from repro_torch.train.optimizer import cast_params, init_state  # noqa: E402

# The RG-LRU backward kernel against rglru_bwd_ref (f32, sequential) on the
# same inputs: in f32 every gradient within a relative L2 error of 1e-4 (the
# CPU tests' tolerance against the JAX package's autodiff; the two differ in
# summation order, expf and fused multiply-adds); in bf16 dx, dr and di are
# rounded once to bf16 (relative L2 ~1e-3), d a_param and dh0 stay f32.
RGLRU_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.mark.cuda
class TestTrainOnCard:
    # The flash kernel's log-sum-exp against the plain version's in f32 (the
    # same f32 logits summed in another order), and the gradients of
    # ``chunked_attention`` on the card (the kernel's forward, then
    # ``flash_bwd``) against ``flash_bwd`` fed the f32 reference's output
    # and lse, within a relative L2 error of 2e-2 (the kernel's output is
    # bf16, which enters delta = rowsum(dO O)).
    @pytest.mark.parametrize("B, Sq, Sk, H, Hkv, D, causal, window", [
        (2, 300, 300, 8, 2, 128, True, 0), (1, 257, 257, 4, 1, 256, True, 100),
        (2, 64, 200, 4, 4, 64, False, 0), (2, 150, 150, 4, 2, 64, False, 0)])
    def test_lse_and_grads_match_f32_reference(self, cuda, B, Sq, Sk, H, Hkv, D, causal,
                                               window):
        q, k, v = _qkv(cuda, B, Sq, Sk, H, Hkv, D, seed=Sq + D)
        do = _qkv(cuda, B, Sq, Sq, H, H, D, seed=Sk)[0]
        out, lse = flash_attention_cuda(q, k, v, causal, window, 0.0, return_lse=True)
        want_o, want_lse = chunked_attention_f32_ref(q, k, v, causal, window, 0.0,
                                                     return_lse=True)
        assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
        torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)
        assert torch.equal(out, flash_attention_cuda(q, k, v, causal, window, 0.0))
        spec = torch_attention.AttnSpec(causal=causal, window=window)
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
        before = flash_attention_cuda.launches
        torch_attention.chunked_attention(qg, kg, vg, spec).backward(do)
        assert flash_attention_cuda.launches == before + 1
        want = torch_attention.flash_bwd(q, k, v, want_o, want_lse, do, spec)
        for t, w in zip((qg, kg, vg), want):
            assert t.grad.dtype == torch.bfloat16 and t.grad.shape == t.shape
            assert _rel_l2(t.grad, w) < 2e-2

    def test_backward_reaches_every_leaf(self, cuda):
        """yi-6b at full width, one layer: f32 masters cast to bf16 in the
        graph; ``loss.backward()`` gives every master a finite f32 gradient,
        q, k and v's weights a nonzero one, with two flash launches (the
        forward and the remat recompute)."""
        cfg = dataclasses.replace(get_config("yi_6b"), segments=uniform("attn", 1))
        state = init_state(init_params(torch_lm.build_specs(cfg), seed=1, device=cuda))
        masters = {k: v.requires_grad_(True) for k, v in state.params.items()}
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (1, 257)).astype(np.int32)).to(cuda)
        before = flash_attention_cuda.launches
        loss, _ = torch_lm.lm_loss(cfg, cast_params(masters),
                                   {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
        loss.backward()
        assert flash_attention_cuda.launches == before + 2
        assert torch.isfinite(loss)
        for k, p in masters.items():
            assert p.grad is not None and p.grad.dtype == torch.float32, k
            assert torch.isfinite(p.grad).all(), k
        for leaf in ("wq", "wk", "wv", "wo"):
            assert masters[f"seg0/l0/attn/{leaf}"].grad.norm() > 0, leaf

    def test_kernels_without_a_backward_raise_under_grad(self, cuda):
        q, k, v = _qkv(cuda, 1, 64, 64, 4, 4, 64, seed=0)
        with pytest.raises(NotImplementedError, match="kv_valid_len"):
            torch_attention.chunked_attention(
                q.requires_grad_(True), k, v, torch_attention.AttnSpec(),
                kv_valid_len=torch.tensor([40], device=cuda))

    # S not a multiple of the 128-step chunk (1000, 257), N not of the
    # 32-channel tile (80, 33); recurrentgemma's training width.
    @pytest.mark.parametrize("B, S, N", [(2, 1000, 80), (1, 257, 33), (2, 512, 4096)])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("with_h0", [False, True])
    def test_rglru_bwd_matches_plain_version(self, cuda, B, S, N, dtype, with_h0):
        rng = np.random.default_rng(B * S + N + with_h0)
        f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)  # noqa: E731
        x, r, i = (t.to(dtype) for t in (f(B, S, N), torch.sigmoid(f(B, S, N)),
                                         torch.sigmoid(f(B, S, N))))
        a_param, h0 = f(N), (f(B, N) if with_h0 else None)
        dy, dh_last = f(B, S, N).to(dtype), (f(B, N) if with_h0 else None)
        _, _, carries = rglru_cuda(x, r, i, a_param, h0, return_carries=True)
        before = rglru_bwd_cuda.launches
        got = rglru_bwd_cuda(x, r, i, a_param, carries, dy, dh_last)
        assert rglru_bwd_cuda.launches == before + 1
        want = rglru_bwd_ref(x, r, i, a_param, h0, dy, dh_last)
        for name, g, w in zip(("dx", "dr", "di", "da_param", "dh0"), got, want):
            tol = RGLRU_BWD_TOL[dtype] if name in ("dx", "dr", "di") else 1e-4
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert torch.isfinite(g).all(), name
            assert _rel_l2(g, w) < tol, (name, _rel_l2(g, w))

    # The redesigned kernel's edges: S below one chunk (1, 127) and an exact
    # multiple of it (256); rows off a 16-byte boundary (contiguous views at
    # storage offset 1: the element path, not the cp.async ring); B 3 at
    # N 4,096 (384 blocks, more than two an SM); dh_last without h0.
    @pytest.mark.parametrize("B, S, N, with_h0, with_dh, offset", [
        (2, 1, 64, True, True, 0), (2, 127, 96, False, True, 0), (1, 256, 128, True, False, 0),
        (2, 300, 64, True, True, 1), (3, 384, 4096, False, False, 0),
        (2, 200, 96, False, True, 0)])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_rglru_bwd_edges_match_plain_version(self, cuda, B, S, N, with_h0, with_dh, offset,
                                                 dtype):
        rng = np.random.default_rng(S + N + offset)
        f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)  # noqa: E731

        def placed(t):  # a contiguous copy ``offset`` elements into its storage
            buf = torch.empty(t.numel() + offset, dtype=dtype, device=cuda)
            view = buf[offset:].view(t.shape)
            view.copy_(t)
            return view

        x, r, i, dy = (placed(t) for t in (f(B, S, N), torch.sigmoid(f(B, S, N)),
                                            torch.sigmoid(f(B, S, N)), f(B, S, N)))
        assert all(t.is_contiguous() and t.storage_offset() == offset for t in (x, r, i, dy))
        a_param = f(N)
        h0, dh_last = (f(B, N) if with_h0 else None), (f(B, N) if with_dh else None)
        _, _, carries = rglru_cuda(x, r, i, a_param, h0, return_carries=True)
        before = rglru_bwd_cuda.launches
        got = rglru_bwd_cuda(x, r, i, a_param, carries, dy, dh_last)
        assert rglru_bwd_cuda.launches == before + 1
        want = rglru_bwd_ref(x, r, i, a_param, h0, dy, dh_last)
        for name, g, w in zip(("dx", "dr", "di", "da_param", "dh0"), got, want):
            tol = RGLRU_BWD_TOL[dtype] if name in ("dx", "dr", "di") else 1e-4
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert torch.isfinite(g).all(), name
            assert _rel_l2(g, w) < tol, (name, _rel_l2(g, w))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_rglru_bwd_is_bit_equal_across_calls(self, cuda, dtype):
        """No atomics: d a_param is summed over warps, chunks and rows in a
        fixed order, so two calls on the same inputs agree bit for bit."""
        rng = np.random.default_rng(28)
        f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)  # noqa: E731
        x, r, i, dy = f(2, 1000, 4096).to(dtype), torch.sigmoid(f(2, 1000, 4096)).to(dtype), \
            torch.sigmoid(f(2, 1000, 4096)).to(dtype), f(2, 1000, 4096).to(dtype)
        a_param, h0, dh_last = f(4096), f(2, 4096), f(2, 4096)
        _, _, carries = rglru_cuda(x, r, i, a_param, h0, return_carries=True)
        first = rglru_bwd_cuda(x, r, i, a_param, carries, dy, dh_last)
        second = rglru_bwd_cuda(x, r, i, a_param, carries, dy, dh_last)
        for name, g, h in zip(("dx", "dr", "di", "da_param", "dh0"), first, second):
            assert torch.equal(g, h), name

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_null_carries_and_states_give_bit_equal_serving_outputs(self, cuda, dtype):
        """Serving passes null carries and states: the outputs are bit-equal
        to a call that writes them, and what is written is the plain
        versions' state entering each chunk."""
        rng = np.random.default_rng(24)
        f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)  # noqa: E731
        x, r, i = f(2, 300, 96).to(dtype), torch.sigmoid(f(2, 300, 96)).to(dtype), \
            torch.sigmoid(f(2, 300, 96)).to(dtype)
        a_param, h0 = f(96), f(2, 96)
        y, h_last = rglru_cuda(x, r, i, a_param, h0)
        y2, h_last2, carries = rglru_cuda(x, r, i, a_param, h0, return_carries=True)
        assert torch.equal(y, y2) and torch.equal(h_last, h_last2)
        want = rglru_ref(x, r, i, a_param, h0, return_carries=True)[2]
        torch.testing.assert_close(carries, want, rtol=2e-4, atol=2e-4)
        for shared in (True, False):
            args = _ssd_inputs(cuda, 2, 300, 32, 64, 128, dtype, shared, True, seed=24)
            y, h_last = ssd_cuda(*args)
            y2, h_last2, states = ssd_cuda(*args, return_states=True)
            assert torch.equal(y, y2) and torch.equal(h_last, h_last2)
            want = ssd_chunked_ref(*[a.float() for a in args[:6]], 128, args[6],
                                   return_states=True)[2]
            assert states.shape == (2, 32, 3, 128, 64)
            torch.testing.assert_close(states, want, rtol=2e-3, atol=SSD_H_ATOL[dtype])

    @pytest.mark.parametrize("B, S, H, P, N, shared, with_h0", [
        (2, 300, 4, 32, 16, False, True), (2, 257, 32, 64, 128, True, False),
        (1, 1000, 8, 64, 128, True, True)])
    def test_ssd_bwd_matches_autograd_of_plain_version(self, cuda, B, S, H, P, N, shared,
                                                       with_h0):
        """f32: ``ssd_bwd`` fed the kernel's states against autograd through
        ``ssd_chunked_ref``, within 2e-4 (the JAX package's SSD tolerance)."""
        x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(cuda, B, S, H, P, N, torch.float32, shared,
                                              with_h0, seed=S + H)
        dt = dt * 0.2  # chunk decays below e^-88 (the plain version's autograd NaNs past it)
        gen = torch.Generator(device=cuda).manual_seed(S)
        dy = torch.randn((B, S, H, P), device=cuda, generator=gen)
        dh_last = torch.randn((B, H, N, P), device=cuda, generator=gen) if with_h0 else None
        Bs, Cs = (Bm[:, :, 0], Cm[:, :, 0]) if shared else (Bm, Cm)
        _, _, states = ssd_cuda(x, dt, A, Bm, Cm, D, h0, return_states=True)
        got = ssd_bwd(x, dt, A, Bs, Cs, D, states, dy, dh_last, 128)
        leaves = [None if t is None else t.detach().clone().requires_grad_(True)
                  for t in (x, dt, A, Bs, Cs, D, h0)]
        heads = [t[:, :, None].expand(B, S, H, N) if shared else t for t in leaves[3:5]]
        y, h_last = ssd_chunked_ref(*leaves[:3], *heads, leaves[5], 128, leaves[6])
        ((y * dy).sum() + (0 if dh_last is None else (h_last * dh_last).sum())).backward()
        for name, g, leaf in zip(("dx", "ddt", "dA", "dBm", "dCm", "dD", "dh0"), got, leaves):
            if leaf is None:
                continue
            assert g.shape == leaf.shape and torch.isfinite(g).all(), name
            assert _rel_l2(g, leaf.grad) < 2e-4, (name, _rel_l2(g, leaf.grad))

    @pytest.mark.parametrize("arch, pattern", [("mamba2_370m", ("ssm",)),
                                               ("recurrentgemma_9b", ("rglru", "rglru", "attn"))])
    def test_backward_reaches_every_leaf_of_recurrent_models(self, cuda, arch, pattern):
        """Full width, 2 layers: every f32 master gets a finite gradient,
        through the kernels only: per layer two forward launches (the
        forward and the remat recompute) and one RG-LRU backward launch."""
        cfg = dataclasses.replace(get_config(arch), segments=patterned(pattern, 2))
        state = init_state(init_params(torch_lm.build_specs(cfg), seed=1, device=cuda))
        masters = {k: v.requires_grad_(True) for k, v in state.params.items()}
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (2, 258)).astype(np.int32)).to(cuda)
        before = (rglru_cuda.launches, rglru_bwd_cuda.launches, ssd_cuda.launches)
        loss, _ = torch_lm.lm_loss(cfg, cast_params(masters),
                                   {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
        loss.backward()
        rg = 2 if arch == "recurrentgemma_9b" else 0
        assert (rglru_cuda.launches - before[0], rglru_bwd_cuda.launches - before[1],
                ssd_cuda.launches - before[2]) == (2 * rg, rg, 4 - 2 * rg)
        assert torch.isfinite(loss)
        for k, p in masters.items():
            assert p.grad is not None and p.grad.dtype == torch.float32, k
            assert torch.isfinite(p.grad).all(), k
            assert p.grad.norm() > 0, k
