"""Parity of the port's segagg op (``repro_torch.kernels.segagg``) with the
JAX package's, on the same numpy inputs.

On the CPU the port runs its plain PyTorch version; the reference runs its
Pallas kernel bodies in interpret mode with each formulation forced.  Counts
are compared exactly, float sums within the reference's f32 tolerance
(2e-5).  The kernels themselves are held against the plain version on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segagg import ops as jops
from repro.kernels.segagg.ref import segagg_ref as jsegagg_ref
from repro_torch.kernels.segagg import ops, tuning
from repro_torch.kernels.segagg.ref import (
    combine_ref,
    pane_segagg_ref,
    segagg_ref,
    zipf_keys,
)
from repro_torch.kernels.segagg.segagg import (
    NARROW_TABLE_BYTES,
    segagg_narrow_cuda,
    segagg_scatter_atomic_cuda,
    segagg_scatter_cuda,
)

F32 = dict(rtol=2e-5, atol=2e-5)

# Not block multiples in N, G or V; G on both sides of the crossover.
SHAPES = [(100, 7, 1), (1000, 37, 3), (513, 300, 1), (64, 1000, 1),
          (2048, 1, 2), (1531, 129, 5)]
# The reference's two formulations, each forced; the port's plain version
# is the one CPU path for both.
REF_FORMULATIONS = ["matmul", "scatter"]


def _inputs(n, g, v, seed, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    keys = rng.integers(lo, g if hi is None else hi, n).astype(np.int32)
    vals = rng.standard_normal((n, v)).astype(np.float32)
    return keys, vals


def _port(keys, vals, g, **kw):
    return ops.segagg(torch.from_numpy(keys), torch.from_numpy(vals), g, **kw).numpy()


class TestSegAggParity:
    @pytest.mark.parametrize("ref_form", REF_FORMULATIONS)
    @pytest.mark.parametrize("n, g, v", SHAPES)
    def test_float_sums_match_interpret(self, ref_form, n, g, v):
        keys, vals = _inputs(n, g, v, seed=n * 31 + g)
        got = _port(keys, vals, g)
        want = np.asarray(jops.segagg(jnp.asarray(keys), jnp.asarray(vals), g,
                                      backend="interpret", formulation=ref_form))
        assert got.shape == (g, v) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **F32)

    @pytest.mark.parametrize("n, g", [(1000, 37), (513, 300), (4096, 64), (777, 1)])
    def test_counts_exact(self, n, g):
        keys, _ = _inputs(n, g, 1, seed=n)
        got = ops.group_count(torch.from_numpy(keys), g).numpy()
        want = np.asarray(jops.group_count(jnp.asarray(keys), g, backend="interpret"))
        np.testing.assert_array_equal(got, want)
        assert got.sum() == n

    @pytest.mark.parametrize("ref_form", REF_FORMULATIONS)
    def test_empty_input(self, ref_form):
        keys, vals = np.zeros(0, np.int32), np.zeros((0, 3), np.float32)
        got = _port(keys, vals, 11)
        want = np.asarray(jops.segagg(jnp.asarray(keys), jnp.asarray(vals), 11,
                                      backend="interpret", formulation=ref_form))
        np.testing.assert_array_equal(got, want)
        assert got.shape == (11, 3) and not got.any()

    @pytest.mark.parametrize("n, g, v", [(900, 13, 2), (2000, 1, 1), (333, 400, 3)])
    def test_out_of_range_keys_dropped(self, n, g, v):
        keys, vals = _inputs(n, g, v, seed=7, lo=-g - 3, hi=2 * g + 3)
        assert (keys < 0).any() and (keys >= g).any()
        got = _port(keys, vals, g)
        want = np.asarray(jsegagg_ref(jnp.asarray(keys), jnp.asarray(vals), g))
        np.testing.assert_allclose(got, want, **F32)
        inside = (keys >= 0) & (keys < g)
        np.testing.assert_allclose(got.sum(0), vals[inside].sum(0), rtol=1e-4, atol=1e-3)

    @pytest.mark.parametrize("n, panes, g, v", [(300, 5, 7, 3), (1024, 8, 16, 1),
                                                (777, 3, 41, 2)])
    def test_pane_segagg_matches_interpret(self, n, panes, g, v):
        keys, vals = _inputs(n, g, v, seed=n + panes)
        pane_ids = np.sort(np.random.default_rng(panes).integers(0, panes, n)).astype(np.int32)
        got = ops.pane_segagg(torch.from_numpy(keys), torch.from_numpy(vals),
                              torch.from_numpy(pane_ids), panes, g).numpy()
        want = np.asarray(jops.pane_segagg(jnp.asarray(keys), jnp.asarray(vals),
                                           jnp.asarray(pane_ids), panes, g,
                                           backend="interpret"))
        assert got.shape == (panes, g, v)
        np.testing.assert_allclose(got, want, **F32)
        plain = pane_segagg_ref(torch.from_numpy(keys), torch.from_numpy(vals),
                                torch.from_numpy(pane_ids), panes, g).numpy()
        np.testing.assert_allclose(got, plain, **F32)

    def test_combine_and_merge_are_batch_sums(self):
        keys, vals = _inputs(2000, 31, 2, seed=3)
        parts = torch.stack([
            ops.segagg(torch.from_numpy(keys[i:i + 500]),
                       torch.from_numpy(vals[i:i + 500]), 31)
            for i in range(0, 2000, 500)])
        whole = _port(keys, vals, 31)
        for fn in (ops.combine, ops.merge_panes, combine_ref):
            np.testing.assert_allclose(fn(parts).numpy(), whole, rtol=1e-4, atol=1e-4)

    def test_segagg_ref_accumulates_float64_when_given_float64(self):
        keys, vals = _inputs(500, 9, 2, seed=4)
        out = segagg_ref(torch.from_numpy(keys), torch.from_numpy(vals).double(), 9)
        assert out.dtype == torch.float64
        np.testing.assert_allclose(out.numpy(), _port(keys, vals, 9), rtol=1e-5, atol=1e-5)


class TestPaneSegAggOverflow:
    def test_composite_within_int32_ok(self):
        assert ops.pane_composite_groups(2, 3) == 6
        assert ops.pane_composite_groups(1, 2**31 - 1) == 2**31 - 1

    def test_composite_overflow_raises(self):
        with pytest.raises(ValueError, match="exceeds int32"):
            ops.pane_composite_groups(2**16, 2**15)
        with pytest.raises(ValueError, match="exceeds int32"):
            jops.pane_composite_groups(2**16, 2**15)

    def test_pane_segagg_overflow_raises_before_compute(self):
        z = torch.zeros(4, dtype=torch.int32)
        with pytest.raises(ValueError, match="exceeds int32"):
            ops.pane_segagg(z, torch.ones((4, 1)), z, 2**20, 2**20)


class TestDispatch:
    def test_pick_formulation_both_sides_of_crossover(self):
        m = tuning.matmul_max_g("cuda")
        if m >= 1:
            assert tuning.pick_formulation("cuda", 2048, m, 1) == "narrow"
        assert tuning.pick_formulation("cuda", 2048, m + 1, 1) == "scatter"
        assert tuning.pick_formulation("cuda", 2048, 360_000, 1) == "scatter"
        assert tuning.pick_formulation("cuda", 2048, 1, 1) == ("narrow" if m >= 1 else "scatter")
        # both sides give the same sums as the reference
        for g in (max(m, 1), m + 1):
            keys, vals = _inputs(2048, g, 1, seed=g)
            want = np.asarray(jsegagg_ref(jnp.asarray(keys), jnp.asarray(vals), g))
            np.testing.assert_allclose(_port(keys, vals, g), want, **F32)

    def test_narrow_needs_its_table_to_fit(self):
        floats = NARROW_TABLE_BYTES // 4
        assert tuning.narrow_fits(floats, 1) and not tuning.narrow_fits(floats + 1, 1)
        assert tuning.narrow_fits(4, floats // 4) and not tuning.narrow_fits(4, floats // 4 + 1)
        # G under the crossover, but the table does not fit: scatter
        backend = "no-such-backend"  # the defaults: G = 4 is under the crossover
        assert tuning.pick_formulation(backend, 100, 4, floats // 4) == "narrow"
        assert tuning.pick_formulation(backend, 100, 4, floats // 4 + 1) == "scatter"

    def test_shape_class_buckets(self):
        assert tuning.shape_class(1_000, 64) == "small-narrow"
        assert tuning.shape_class(1_000, 50_000) == "small-wide"
        assert tuning.shape_class(500_000, 64) == "large-narrow"
        assert tuning.shape_class(500_000, 50_000) == "large-wide"

    def test_flops_bytes_counts_real_extents(self):
        # no 128-lane V padding, no padded rows, no sacrificial group
        assert ops.flops_bytes(1000, 37, 3) == (3000.0, 4.0 * (1000 + 3000 + 111))
        assert ops.flops_bytes(29_250_000, 1_500_000, 1) == (
            29_250_000.0, 4.0 * (2 * 29_250_000 + 1_500_000))
        _, ref_bytes = jops.flops_bytes(1000, 37, 3, "scatter", backend="xla")
        assert ops.flops_bytes(1000, 37, 3)[1] == ref_bytes

    def test_cuda_backend_on_cpu_tensor_raises(self):
        keys, vals = torch.zeros(8, dtype=torch.int32), torch.ones((8, 1))
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            ops.segagg(keys, vals, 4, backend="cuda")
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            ops.group_count(keys, 4, backend="cuda")

    def test_unknown_backend_and_formulation_rejected(self):
        keys, vals = torch.zeros(8, dtype=torch.int32), torch.ones((8, 1))
        with pytest.raises(ValueError, match="unknown segagg backend"):
            ops.segagg(keys, vals, 4, backend="interpret")
        with pytest.raises(ValueError, match="unknown segagg formulation"):
            ops.segagg(keys, vals, 4, formulation="onehot")
        with pytest.raises(ValueError, match="positive"):
            ops.segagg(keys, vals, 0)

    def test_auto_on_cpu_takes_the_plain_version(self):
        assert ops.resolve_backend(None, torch.device("cpu")) == "plain"
        assert ops.resolve_backend("auto", torch.device("cuda")) == "cuda"
        assert ops.resolve_backend("cuda", torch.device("cuda")) == "cuda"

    def test_kernel_wrappers_refuse_cpu_tensors(self):
        keys, vals = torch.zeros(8, dtype=torch.int32), torch.ones((8, 1))
        for fn in (segagg_scatter_cuda, segagg_narrow_cuda):
            before = fn.launches
            with pytest.raises(ValueError, match="CUDA"):
                fn(keys, vals, 4)
            assert fn.launches == before

    def test_cpu_path_never_counts_a_launch(self):
        before = (segagg_scatter_cuda.launches, segagg_narrow_cuda.launches)
        keys, vals = _inputs(500, 5, 1, seed=1)
        _port(keys, vals, 5)
        _port(keys, vals, 5000)
        assert (segagg_scatter_cuda.launches, segagg_narrow_cuda.launches) == before


# The H100's opt-in shared memory a block and largest cluster (what
# ``segagg.scatter_plan_for`` reads from the card there).
H100_SMEM = 232_448
PANE_G = 16_000_000


def _small_smem(chunks):
    """Shared memory for `chunks` table chunks and the least inboxes a
    cluster of 8 takes."""
    least = -(-int(tuning.SCATTER_MIN_FILL * tuning.SCATTER_ROUND) // 8)
    return tuning.cluster_smem_bytes(8, chunks, least)


def _ranges_sum(keys, vals, g, ranges):
    """``segagg_ref`` summed over ``ranges`` of the flat (G, V) index
    ``key * V + column``, with each element masked to the range it falls
    in: the cluster-table scatter's decomposition in plain PyTorch."""
    n, v = vals.shape
    k = torch.from_numpy(keys).to(torch.int64)
    flat = torch.where((k >= 0) & (k < g), k * v, -1)[:, None]
    flat = torch.where(flat >= 0, flat + torch.arange(v), -1).reshape(-1)
    x = torch.from_numpy(vals).reshape(n * v, 1)
    out = torch.zeros(g * v)
    for lo, hi in ranges:
        part = segagg_ref(torch.where((flat >= lo) & (flat < hi), flat, -1), x, g * v)
        out[lo:hi] += part[lo:hi, 0]
    return out.reshape(g, v).numpy()


class TestScatterPlan:
    @pytest.mark.parametrize("g, v, max_blocks, route, cluster", [
        (360_000, 1, 16, "cluster", 8),       # CQ3: one range, portable cluster
        (360_000, 1, 8, "cluster", 8),
        (600_000, 1, 16, "cluster", 16),      # past a cluster of 8's table
        (600_000, 1, 8, "atomic", 0),         # ... where 16 blocks are refused
        (1_500_000, 1, 16, "atomic", 0),      # CQ4: two ranges, which lose
        (360_000, 3, 16, "atomic", 0),        # V = 3: 1.08M floats
        (PANE_G, 1, 16, "atomic", 0),         # pane-sized composite keys
        (1, 1, 16, "cluster", 8),
    ])
    def test_plan_at_path_shapes(self, g, v, max_blocks, route, cluster):
        plan = tuning.scatter_plan(g, v, max_blocks, H100_SMEM)
        assert (plan.route, plan.cluster) == (route, cluster)
        if route == "cluster":
            assert plan.ranges == ((0, g * v),)
            assert plan.range_len % tuning.SCATTER_CHUNK == 0
            # the table slice and the inboxes fit the block's shared memory
            assert plan.smem_bytes <= H100_SMEM
            assert plan.slice_chunks * plan.cluster * tuning.SCATTER_CHUNK >= plan.range_len
            assert plan.capacity >= (tuning.SCATTER_MIN_FILL * tuning.SCATTER_ROUND
                                     / plan.cluster)
        else:
            assert plan == tuning.ScatterPlan("atomic")

    @pytest.mark.parametrize("g, v, max_ranges", [
        (1_500_000, 1, 2), (1_500_000, 1, 3), (360_000, 3, 2), (PANE_G, 1, 2),
        (1000, 2, 3), (2_000_000, 1, 4)])
    def test_ranges_tile_the_table(self, g, v, max_ranges):
        plan = tuning.scatter_plan(g, v, 16, H100_SMEM, max_ranges=max_ranges)
        if plan.route == "atomic":
            # past the ranges allowed: the table needs more than max_ranges
            assert tuning.scatter_plan(g, v, 16, H100_SMEM, max_ranges=64).route == "cluster"
            assert len(tuning.scatter_plan(g, v, 16, H100_SMEM, max_ranges=64).ranges) > max_ranges
            return
        assert 1 <= len(plan.ranges) <= max_ranges
        # the kernel counts the ranges as ceil(G*V / range_len)
        assert len(plan.ranges) == -(-g * v // plan.range_len)
        covered = np.zeros(g * v, np.int64)
        for lo, hi in plan.ranges:
            assert 0 < hi - lo <= plan.range_len
            covered[lo:hi] += 1
        assert (covered == 1).all()  # [0, G*V) exactly, without overlap
        assert plan.smem_bytes <= H100_SMEM

    def test_fewest_ranges_first(self):
        # CQ4 takes two ranges of 16 blocks when two are allowed
        plan = tuning.scatter_plan(1_500_000, 1, 16, H100_SMEM, max_ranges=2)
        assert (plan.cluster, plan.ranges) == (16, ((0, 750_000), (750_000, 1_500_000)))

    def test_wide_route_past_the_limit(self):
        g = 8 * (H100_SMEM // 32) * tuning.SCATTER_CHUNK
        # the largest table a cluster of 8 takes leaves no inbox: 16 blocks
        assert tuning.scatter_plan(g // 2, 1, 16, H100_SMEM).cluster == 8
        assert tuning.scatter_plan(g, 1, 16, H100_SMEM).cluster == 16
        assert tuning.scatter_plan(2 * g, 1, 16, H100_SMEM).route == "atomic"
        # a card with no room for a table chunk takes the wide route
        assert tuning.scatter_plan(5, 1, 16, 16).route == "atomic"
        assert tuning.scatter_plan(5, 1, 4, H100_SMEM).route == "atomic"

    def test_inbox_fill_limit(self):
        # inboxes shrink as the table grows, down to SCATTER_MIN_FILL
        caps = [tuning.scatter_plan(g, 1, 16, H100_SMEM).capacity
                for g in (100_000, 600_000, 800_000)]
        assert caps == sorted(caps, reverse=True)
        assert tuning.scatter_plan(900_000, 1, 16, H100_SMEM).route == "atomic"

    def test_smem_bytes_matches_layout(self):
        plan = tuning.scatter_plan(360_000, 1, 16, H100_SMEM)
        assert plan.smem_bytes == (plan.slice_chunks * 32
                                   + tuning.SCATTER_BUFFERS * 8 * plan.capacity * 8
                                   + (tuning.SCATTER_BUFFERS + 2) * 8 * 4)
        assert tuning.ScatterPlan("atomic").smem_bytes == 0

    @pytest.mark.parametrize("active, ranges, want", [(15, 1, 15), (7, 2, 7), (1, 2, 2),
                                                      (0, 1, 1)])
    def test_scatter_clusters(self, active, ranges, want):
        assert tuning.scatter_clusters(active, ranges) == want

    @pytest.mark.parametrize("g, v, chunks", [(200, 1, 2), (333, 3, 8), (4096, 1, 32),
                                             (57, 2, 1)])
    def test_range_decomposition_matches_reference(self, g, v, chunks):
        # room for `chunks` table chunks a block forces several ranges at a small G
        plan = tuning.scatter_plan(g, v, 8, _small_smem(chunks), max_ranges=8)
        assert plan.route == "cluster" and len(plan.ranges) >= 2
        rng = np.random.default_rng(g + v)
        n = 3001
        keys = rng.integers(-3, g + 3, n).astype(np.int32)
        # keys on every range boundary, on both sides
        edges = np.array([b // v + d for lo, hi in plan.ranges for b in (lo, hi)
                          for d in (-1, 0, 1)], np.int32)
        keys[: len(edges)] = edges
        vals = rng.standard_normal((n, v)).astype(np.float32)
        assert (keys < 0).any() and (keys >= g).any()
        got = _ranges_sum(keys, vals, g, plan.ranges)
        want = np.asarray(jsegagg_ref(jnp.asarray(keys), jnp.asarray(vals), g))
        np.testing.assert_allclose(got, want, **F32)


class TestZipfKeys:
    def test_hot_group_share_and_range(self):
        g, n = 360_000, 400_000
        keys = zipf_keys(n, g, seed=5)
        assert keys.dtype == torch.int32 and keys.shape == (n,)
        assert int(keys.min()) >= 0 and int(keys.max()) < g
        share = torch.bincount(keys, minlength=g).max().item() / n
        harmonic = float(np.sum(1.0 / np.arange(1, g + 1)))
        assert abs(share - 1.0 / harmonic) < 0.005  # 7.5% at 360,000 groups

    def test_seeded(self):
        assert torch.equal(zipf_keys(1000, 50, seed=1), zipf_keys(1000, 50, seed=1))
        assert not torch.equal(zipf_keys(1000, 50, seed=1), zipf_keys(1000, 50, seed=2))

    def test_port_matches_reference_on_zipf_keys(self):
        keys = zipf_keys(5000, 300, seed=3).numpy()
        vals = np.random.default_rng(3).standard_normal((5000, 2)).astype(np.float32)
        want = np.asarray(jsegagg_ref(jnp.asarray(keys), jnp.asarray(vals), 300))
        np.testing.assert_allclose(_port(keys, vals, 300), want, **F32)
        plan = tuning.scatter_plan(300, 2, 8, _small_smem(5), max_ranges=8)
        assert len(plan.ranges) >= 2
        np.testing.assert_allclose(_ranges_sum(keys, vals, 300, plan.ranges), want, **F32)


class TestAtomicScatterWrapper:
    def test_refuses_cpu_tensors(self):
        keys, vals = torch.zeros(8, dtype=torch.int32), torch.ones((8, 1))
        before = (segagg_scatter_atomic_cuda.launches, segagg_scatter_cuda.launches)
        for fn in (segagg_scatter_atomic_cuda, segagg_scatter_cuda):
            with pytest.raises(ValueError, match="CUDA"):
                fn(keys, vals, 4)
        with pytest.raises(ValueError, match="CUDA"):
            segagg_scatter_cuda(keys, vals, 4, plan=tuning.ScatterPlan("atomic"))
        assert (segagg_scatter_atomic_cuda.launches,
                segagg_scatter_cuda.launches) == before
