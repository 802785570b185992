"""The port's segagg tuning table (``repro_torch.kernels.segagg.tuning``)
against the reference's (``repro.kernels.segagg.tuning``), and the logic of
``scripts/torch_hillclimb.py --segagg`` with injected timers.

The port keeps its own table (``tuned_blocks.json`` beside its module);
every test that saves one points ``TUNED_PATH`` into ``tmp_path`` and
leaves the reference's file byte for byte as it was.  On the CPU the
dispatch still picks and validates a formulation, then runs the plain
version; sums are held against the reference's XLA path at its f32
tolerance (2e-5).
"""
import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segagg import ops as jops
from repro.kernels.segagg import tuning as jtuning
from repro.kernels.segagg.segagg import BLOCK_G, BLOCK_N
from repro_torch.kernels.segagg import ops, tuning
from repro_torch.kernels.segagg import segagg as psegagg

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_TABLE = ROOT / "src" / "repro" / "kernels" / "segagg" / "tuned_blocks.json"
F32 = dict(rtol=2e-5, atol=2e-5)
# The H100's opt-in shared memory a block (what ``scatter_caps`` reads there).
H100_SMEM = 232_448
DEFAULTS = (tuning.SCATTER_CLUSTER_SIZES[0], tuning.SCATTER_MAX_RANGES)


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_hillclimb", ROOT / "scripts" / "torch_hillclimb.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def table_at(monkeypatch, tmp_path):
    """The port's ``TUNED_PATH`` in ``tmp_path`` (no file yet)."""
    path = tmp_path / "tuned_blocks.json"
    monkeypatch.setattr(tuning, "TUNED_PATH", path)
    tuning.reload()
    yield path
    tuning.reload()


@pytest.fixture
def ref_table_at(monkeypatch, tmp_path):
    """The reference's ``TUNED_PATH`` in ``tmp_path``: its own file is
    never written."""
    path = tmp_path / "ref_tuned_blocks.json"
    monkeypatch.setattr(jtuning, "TUNED_PATH", path)
    jtuning.reload()
    yield path
    jtuning.reload()


@pytest.fixture
def h100_caps(monkeypatch):
    """``scatter_caps`` as the H100 reports it, so ``scatter_plan_for``
    runs on the CPU."""
    monkeypatch.setattr(psegagg, "scatter_caps", lambda device: (H100_SMEM, 16))


def _inputs(n, g, v, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, g, n).astype(np.int32),
            rng.standard_normal((n, v)).astype(np.float32))


def _port(keys, vals, g, **kw):
    return ops.segagg(torch.from_numpy(keys), torch.from_numpy(vals), g, **kw).numpy()


def _parent_formulation(g, v):
    """The parent's rule: narrow up to 12,288 groups where the table fits."""
    return "narrow" if g <= 12288 and g * v * 4 <= tuning.NARROW_TABLE_BYTES else "scatter"


class TestTableAPI:
    @pytest.mark.parametrize("n", [1, 13_000, 32_768, 32_769, 31_928_000])
    @pytest.mark.parametrize("g", [1, 1_023, 1_024, 1_025, 360_000])
    def test_shape_class_matches_reference(self, n, g):
        assert tuning.shape_class(n, g) == jtuning.shape_class(n, g)

    def test_unknown_backend_gives_defaults(self):
        assert tuning.tuned_blocks("no-such-backend", 100, 10) == DEFAULTS == (8, 1)
        assert jtuning.tuned_blocks("no-such-backend", 100, 10) == (BLOCK_N, BLOCK_G)
        assert tuning.matmul_max_g("no-such-backend") == tuning.DEFAULT_MATMUL_MAX_G

    @pytest.mark.parametrize("content", [None, "not json", "{}"])
    def test_missing_or_bad_file_gives_defaults(self, table_at, content):
        if content is not None:
            table_at.write_text(content)
        assert tuning.matmul_max_g("cuda") == tuning.DEFAULT_MATMUL_MAX_G == 12288
        for n, g in ((13_000, 5), (26_000, 360_000), (31_928_000, 1_500_000)):
            assert tuning.tuned_blocks("cuda", n, g) == DEFAULTS

    def test_save_reload_round_trip(self, table_at, ref_table_at):
        ref_bytes = REF_TABLE.read_bytes()
        table = {"version": 1,
                 "blocks": {"cuda:large-wide": {"cluster": 16, "max_ranges": 2}},
                 "crossover": {"cuda": {"matmul_max_g": 2048}}}
        assert tuning.matmul_max_g("cuda") == 12288  # cached before the save
        assert tuning.save(table) == table_at
        assert json.loads(table_at.read_text()) == table
        assert tuning.matmul_max_g("cuda") == 2048
        assert tuning.tuned_blocks("cuda", 31_928_000, 360_000) == (16, 2)
        assert tuning.tuned_blocks("cuda", 26_000, 360_000) == DEFAULTS
        assert tuning.matmul_max_g("xla") == tuning.DEFAULT_MATMUL_MAX_G
        # the reference's format, written by the reference into tmp_path
        jtuning.save(table)
        assert table_at.read_bytes() == ref_table_at.read_bytes()
        tuning.reload()
        assert tuning.matmul_max_g("cuda") == 2048
        assert REF_TABLE.read_bytes() == ref_bytes

    @pytest.mark.parametrize("max_g", [0, 4, 64, 4096])
    def test_pick_formulation_both_sides_of_saved_crossover(self, table_at, ref_table_at,
                                                            max_g):
        tuning.save({"version": 1, "crossover": {"cuda": {"matmul_max_g": max_g}}})
        jtuning.save({"version": 1, "crossover": {"xla": {"matmul_max_g": max_g}}})
        names = {"narrow": "matmul", "scatter": "scatter"}
        for g in (1, 2, 4, 5, 63, 64, 65, 4096, 4097, 360_000):
            got = tuning.pick_formulation("cuda", 2048, g, 1)
            assert got == ("narrow" if g <= max_g else "scatter")
            assert names[got] == jtuning.pick_formulation("xla", 2048, g, 1)

    def test_override_names(self):
        for g in (1, 5, 12288):
            assert tuning.pick_formulation("cuda", 100, g, 1, "matmul") == "narrow"
            assert tuning.pick_formulation("cuda", 100, g, 1, "scatter") == "scatter"
        assert tuning.pick_formulation("cuda", 100, 360_000, 1, "scatter") == "scatter"

    def test_bad_formulation_rejected(self):
        with pytest.raises(ValueError, match="unknown segagg formulation") as port:
            tuning.pick_formulation("cuda", 100, 4, 1, "hash")
        with pytest.raises(ValueError, match="unknown segagg formulation") as ref:
            jtuning.pick_formulation("xla", 100, 4, 1, "hash")
        assert str(port.value) == str(ref.value)
        with pytest.raises(ValueError, match="unknown segagg formulation") as port:
            ops.segagg(torch.zeros(8, dtype=torch.int32), torch.ones((8, 1)), 4,
                       formulation="hash")
        with pytest.raises(ValueError, match="unknown segagg formulation") as ref:
            jops.segagg(jnp.zeros((8,), jnp.int32), jnp.ones((8, 1)), 4,
                        backend="xla", formulation="hash")
        assert str(port.value) == str(ref.value)

    @pytest.mark.parametrize("g, v", [(12289, 1), (4097, 3), (1, 12289)])
    def test_forced_matmul_that_does_not_fit_raises(self, g, v):
        assert not tuning.narrow_fits(g, v)
        with pytest.raises(ValueError, match="formulation='matmul'"):
            tuning.pick_formulation("cuda", 100, g, v, "matmul")
        keys, vals = _inputs(100, g, v, seed=g)
        with pytest.raises(ValueError, match="formulation='matmul'"):
            _port(keys, vals, g, formulation="matmul")
        np.testing.assert_allclose(_port(keys, vals, g, formulation="scatter"),
                                   _port(keys, vals, g), **F32)


class TestUntunedRoutes:
    """Without a table the port routes every shape as its parent did:
    the same kernel and the same scatter plan."""

    @pytest.mark.parametrize("n", [1, 13_000, 1_261_000, 31_928_000])
    def test_same_kernel(self, table_at, n):
        for g in (1, 5, 1024, 1025, 4096, 12288, 12289, 360_000, 1_500_000):
            for v in (1, 3, 13):
                assert tuning.pick_formulation("cuda", n, g, v) == _parent_formulation(g, v)

    @pytest.mark.parametrize("largest", [8, 16])
    @pytest.mark.parametrize("n", [13_000, 31_928_000])
    def test_same_scatter_plan(self, table_at, monkeypatch, largest, n):
        monkeypatch.setattr(psegagg, "scatter_caps", lambda device: (H100_SMEM, largest))
        for g in (12289, 360_000, 1_500_000, 16_000_000):
            for v in (1, 3):
                got = psegagg.scatter_plan_for(g, v, "cuda", n=n)
                assert got == tuning.scatter_plan(g, v, largest, H100_SMEM)

    def test_tuned_entries_feed_the_plan(self, table_at, h100_caps):
        tuning.save({"version": 1,
                     "blocks": {"cuda:large-wide": {"cluster": 16, "max_ranges": 2}}})
        cq3 = psegagg.scatter_plan_for(360_000, 1, "cuda", n=31_928_000)
        assert cq3.route == "cluster" and cq3.cluster == 16 and len(cq3.ranges) == 1
        cq4 = psegagg.scatter_plan_for(1_500_000, 1, "cuda", n=30_732_000)
        assert cq4.route == "cluster" and len(cq4.ranges) == 2
        # another shape class keeps the defaults; an explicit argument wins
        assert psegagg.scatter_plan_for(1_500_000, 1, "cuda", n=26_000).route == "atomic"
        assert psegagg.scatter_plan_for(1_500_000, 1, "cuda", n=30_732_000,
                                        max_ranges=1).route == "atomic"
        forced = psegagg.scatter_plan_for(360_000, 1, "cuda", n=31_928_000, sizes=(8,))
        assert forced.cluster == 8


class TestBoundarySums:
    """Sums at the table's boundary and one past it, by the table's choice
    and forced, against the reference's XLA path (as the reference's
    ``test_crossover_boundary`` holds its own)."""

    @pytest.mark.parametrize("form", [None, "matmul", "scatter"])
    def test_against_reference(self, form):
        m = tuning.matmul_max_g("cuda")
        for g in (max(m, 1), m + 1):
            keys, vals = _inputs(2048, g, 1, seed=g)
            want = np.asarray(jops.segagg(jnp.asarray(keys), jnp.asarray(vals), g,
                                          backend="xla", formulation=form))
            if form == "matmul" and not tuning.narrow_fits(g, 1):
                with pytest.raises(ValueError, match="formulation='matmul'"):
                    _port(keys, vals, g, formulation=form)
                continue
            np.testing.assert_allclose(_port(keys, vals, g, formulation=form), want, **F32)


class TestHillclimbLogic:
    """``scripts/torch_hillclimb.py``'s crossover and hill-climb with
    injected timers (ms)."""

    @pytest.fixture(scope="class")
    def hc(self):
        return _script()

    def test_every_g_and_every_row_count(self, hc):
        def timer(n, g, form):  # narrow loses only at 1,261,000 rows from G = 512
            return 1.2 if (form == "matmul" and n == 1_261_000 and g >= 512) else 1.0

        max_g, per_rows, medians = hc.crossover_sweep(timer)
        assert max_g == 256
        assert per_rows == {13_000: 12288, 1_261_000: 256, 29_250_000: 12288}
        assert [r["g"] for r in medians[13_000]] == list(hc.GROUPS)

    def test_the_first_loss_ends_the_run(self, hc):
        def timer(n, g, form):  # one loss at G = 64, wins on both sides of it
            return 2.0 if (form == "matmul" and g == 64) else 1.0

        assert hc.crossover_sweep(timer)[0] == 32
        assert hc.crossover_sweep(lambda n, g, f: 2.0 if f == "matmul" else 1.0)[0] == 0

    def test_wrong_counts_never_win(self, hc):
        def timer(n, g, form):  # scatter's counts wrong at G = 1 of the largest N
            if n == 29_250_000 and g == 1:
                return 5.0 if form == "matmul" else None
            return 1.0

        assert hc.narrow_wins(5.0, None) and not hc.narrow_wins(None, None)
        assert hc.crossover_sweep(timer)[0] == 12288
        assert hc.crossover_sweep(lambda n, g, f: None if f == "matmul" else 1.0)[0] == 0

    @pytest.mark.parametrize("narrow_ms, wins", [(1.0, True), (1.029, True), (1.031, False)])
    def test_margin(self, hc, narrow_ms, wins):
        assert hc.narrow_wins(narrow_ms, 1.0) is wins
        max_g = hc.crossover_sweep(lambda n, g, f: narrow_ms if f == "matmul" else 1.0)[0]
        assert max_g == (12288 if wins else 0)

    @pytest.mark.parametrize("v, cap", [(1, 12288), (3, 4096)])
    def test_capped_where_narrow_fits(self, hc, v, cap):
        asked = []

        def timer(n, g, form):  # narrow always far ahead
            asked.append((g, form))
            return 0.1 if form == "matmul" else 1.0

        groups = hc.GROUPS + (16384, 32768)
        max_g, _, medians = hc.crossover_sweep(timer, rows=(13_000,), groups=groups, v=v)
        assert max_g == cap and tuning.narrow_fits(max_g, v)
        assert all(tuning.narrow_fits(g, v) for g, form in asked if form == "matmul")
        assert medians[13_000][-1]["narrow_ms"] is None

    def test_counts_match(self, hc):
        want = torch.tensor([[3.0], [2.0 ** 24]], dtype=torch.float64)
        assert hc.counts_match(want.float(), want)
        assert not hc.counts_match(want.float() + torch.tensor([[1.0], [0.0]]), want)
        # past 2^24 an f32 count rounds: held within FLOAT_RTOL of the float64 one
        big = torch.tensor([[29_250_001.0]], dtype=torch.float64)
        assert hc.counts_match(big.float(), big) and big.float().double() != big
        assert not hc.counts_match((big * (1 + 2 * hc.FLOAT_RTOL)).float(), big)
        stuck = torch.tensor([[2.0 ** 24]])  # one-element f32 adds of 1 stop here
        assert hc.counts_error(stuck, big) == pytest.approx(1 - 2 ** 24 / 29_250_001)

    def test_neighbours(self, hc):
        assert hc.neighbours(8, 1, 16) == [(16, 1), (8, 2)]
        assert hc.neighbours(8, 1, 8) == [(8, 2)]
        assert hc.neighbours(16, 2, 16) == [(8, 2), (16, 4), (16, 1)]
        assert hc.neighbours(8, 4, 16) == [(16, 4), (8, 2)]

    @pytest.mark.parametrize("cq4_ms, taken", [(1.02, (16, 1)), (1.05, (8, 1))])
    def test_no_slower_at_any_other_representative(self, hc, cq4_ms, taken):
        shapes = ((31_928_000, 360_000), (30_732_000, 1_500_000))

        def timer(n, g, cluster, max_ranges):
            if (cluster, max_ranges) == (16, 1):  # 10% faster at CQ3
                return 0.9 if g == 360_000 else cq4_ms
            return 1.0 if max_ranges == 1 else 1.4  # two ranges lose at both

        best, trials = hc.hillclimb(timer, shapes, largest_cluster=16)
        assert best == taken
        assert trials[0] == {"cluster": 8, "max_ranges": 1, "ms": [1.0, 1.0]}

    def test_within_the_margin_is_no_win(self, hc):
        best, trials = hc.hillclimb(lambda n, g, c, r: 0.975 if c == 16 else 1.0,
                                    ((26_000, 360_000),), largest_cluster=16)
        assert best == (8, 1)
        assert {(t["cluster"], t["max_ranges"]) for t in trials} == {(8, 1), (16, 1), (8, 2)}

    def test_climbs_until_no_move_wins(self, hc):
        ms = {(8, 1): 1.0, (8, 2): 0.8, (8, 4): 0.6, (16, 2): 0.7, (16, 4): 0.65}
        best, trials = hc.hillclimb(lambda n, g, c, r: ms.get((c, r), 2.0),
                                    ((31_928_000, 360_000),), largest_cluster=16)
        assert best == (8, 4)
        assert len({(t["cluster"], t["max_ranges"]) for t in trials}) == len(trials)
