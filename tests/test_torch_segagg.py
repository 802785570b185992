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
from repro_torch.kernels.segagg.ref import combine_ref, pane_segagg_ref, segagg_ref
from repro_torch.kernels.segagg.segagg import (
    NARROW_TABLE_BYTES,
    segagg_narrow_cuda,
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
        m = tuning.MATMUL_MAX_G
        assert tuning.pick_formulation(m, 1) == "narrow"
        assert tuning.pick_formulation(m + 1, 1) == "scatter"
        assert tuning.pick_formulation(360_000, 1) == "scatter"
        assert tuning.pick_formulation(1, 1) == "narrow"
        # both sides give the same sums as the reference
        for g in (m, m + 1):
            keys, vals = _inputs(2048, g, 1, seed=g)
            want = np.asarray(jsegagg_ref(jnp.asarray(keys), jnp.asarray(vals), g))
            np.testing.assert_allclose(_port(keys, vals, g), want, **F32)

    def test_narrow_needs_its_table_to_fit(self):
        floats = NARROW_TABLE_BYTES // 4
        assert tuning.narrow_fits(floats, 1) and not tuning.narrow_fits(floats + 1, 1)
        assert tuning.narrow_fits(4, floats // 4) and not tuning.narrow_fits(4, floats // 4 + 1)
        # G under the crossover, but the table does not fit: scatter
        assert tuning.pick_formulation(4, floats // 4) == "narrow"
        assert tuning.pick_formulation(4, floats // 4 + 1) == "scatter"

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
        with pytest.raises(TypeError, match="formulation"):
            ops.segagg(keys, vals, 4, formulation="matmul")  # chosen, never forced
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
