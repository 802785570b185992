"""The port across ranks on the CPU: processes started as a launcher starts
them (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and a free
``MASTER_PORT`` in the environment, no process group), gloo.

* ``launch/mesh.py`` ``make_host_mesh`` joins the launcher's two ranks,
  (2, 1) and (1, 2) by ``model_parallel``; without those variables it makes
  the one-rank group it always made.
* ``models/params.py`` ``init_params_sharded`` at (2, 1) and (1, 2) on a
  narrowed internvl2-76b (2 layers, the reduced widths): every leaf's
  ``full_tensor()`` bit-equal to ``init_params``, each rank holding only
  its shard; again with every stacked leaf drawn unit by unit, whose
  values (one process) equal the units drawn in order and stacked.
* The (1, 2) prefill program on those weights, in f32, against the JAX
  package's ``repro.models.lm.prefill`` on the same numpy weights
  (``params_from_numpy``'s carry): logits and every cache leaf within
  rtol = atol = 2e-4, ``tests/test_torch_lm.py``'s tolerance for the
  unsharded port in f32 (summation order only); and in bf16, for reduced
  mamba2-370m, recurrentgemma-9b and yi-6b, the (1, 2) program bit-equal
  to the unsharded port's ``prefill``, and likewise for reduced
  mixtral-8x22b and olmoe-1b-7b with their experts split over the ranks.
* ``launch/train.py`` on two ranks: the loss falls, only rank 0 prints and
  writes checkpoints, and ``--resume`` continues from them on both ranks.
* ``scripts/torch_four_cards.py --world 4`` without CUDA exits 2 with one
  line; with ``--cpu`` it rehearses its ranks' parts on four gloo ranks,
  and ``--world 1 --cpu --parts e2`` part (e) at 2 layers on one; it
  imports nothing of JAX.

Each rank is joined with its own timeout, then killed.
"""
import ast
import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.launch.steps import model_specs
from repro_torch.models.base import get_config
from repro_torch.models.config import Segment
from repro_torch.models.params import init_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "torch_four_cards.py"
SPAWN_TIMEOUT = 240
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT")
TOL = dict(rtol=2e-4, atol=2e-4)   # tests/test_torch_lm.py, f32
B, S_TEXT, SEED = 2, 12, 7


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2", **extra)
    return env


def _launch(argv, world: int, cwd=None) -> list:
    """``argv`` started ``world`` times as a launcher starts its ranks;
    returns each rank's output, after all exited 0."""
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, *argv], cwd=cwd,
        env=_env(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                 LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail(f"a rank did not finish within {SPAWN_TIMEOUT} s")
    assert all(p.returncode == 0 for p in procs), \
        "\n".join(o + e for o, e in outs)[-4000:]
    return outs


def _narrow_internvl2():
    cfg = get_config("internvl2_76b").reduced()
    return dataclasses.replace(cfg, segments=(Segment(("attn",), 2),))


# -- make_host_mesh -----------------------------------------------------------

MESH_WORKER = textwrap.dedent("""
    import json, torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    shapes = {mp: list(make_host_mesh(model_parallel=mp, device="cpu").shape) for mp in (1, 2)}
    print(json.dumps({"rank": dist.get_rank(), "world": dist.get_world_size(),
                      "backend": dist.get_backend(), "shapes": shapes}))
    dist.destroy_process_group()
""")


def test_make_host_mesh_joins_the_launchers_ranks():
    outs = _launch(["-c", MESH_WORKER], 2)
    got = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    assert [g["rank"] for g in got] == [0, 1]
    for g in got:
        assert g["world"] == 2 and g["backend"] == "gloo"
        assert g["shapes"] == {"1": [2, 1], "2": [1, 2]}


def test_make_host_mesh_without_a_launcher_has_one_rank():
    out = subprocess.run([sys.executable, "-c", MESH_WORKER], env=_env(), text=True,
                         capture_output=True, timeout=SPAWN_TIMEOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["rank"] == 0 and got["world"] == 1
    assert got["shapes"] == {"1": [1, 1], "2": [1, 1]}


# -- the leaf-wise init and the (1, 2) prefill --------------------------------

INIT_WORKER = textwrap.dedent("""
    import dataclasses, sys, torch, torch.distributed as dist
    from repro_torch.dist.sharding import param_shardings
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.base import ShapeCell, get_config
    from repro_torch.models.config import Segment
    from repro_torch.models.params import init_params, init_params_sharded

    mp, out, sliced = int(sys.argv[1]), sys.argv[2], sys.argv[3] == "sliced"
    if sliced:  # every leaf with a layers axis drawn unit by unit
        import repro_torch.models.params as params_mod
        params_mod.SLICED_DRAW_BYTES = 0
    mesh = make_host_mesh(model_parallel=mp, device="cpu")
    cfg = get_config("internvl2_76b").reduced()
    cfg = dataclasses.replace(cfg, segments=(Segment(("attn",), 2),))
    specs = steps.model_specs(cfg)
    placements = param_shardings(specs, mesh)
    params = init_params_sharded(specs, {SEED}, mesh, placements)
    want = init_params(specs, {SEED}, device="cpu")
    unequal = [k for k in want if not torch.equal(params[k].full_tensor(), want[k])]
    split = [k for k, v in params.items() if v.to_local().numel() < want[k].numel()]
    whole = [k for k, v in params.items()
             if v.to_local().untyped_storage().nbytes() > v.to_local().numel() * v.element_size()]
    result = {{"unequal": unequal, "split": split, "whole": whole, "leaves": len(want)}}
    if mp > 1:  # the prefill program on the same weights in f32
        gen = torch.Generator().manual_seed({SEED})
        tokens = torch.randint(0, cfg.vocab_size, ({B}, {S_TEXT}), generator=gen, dtype=torch.int32)
        patches = torch.randn(({B}, cfg.num_patches, cfg.d_model), generator=gen)
        S = {S_TEXT} + cfg.num_patches
        prog = steps.build_prefill_program(cfg, ShapeCell("p", "prefill", S, {B}), mesh)
        f32 = {{k: v.float() for k, v in params.items()}}
        logits, cache, clen = prog.run(f32, {{"tokens": tokens, "patches": patches}})
        full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
        result.update(tokens=tokens, patches=patches, logits=full(logits), cache_len=int(clen),
                      cache={{k: full(v) for k, v in cache.items()}},
                      placements={{k: str(v.placements) for k, v in params.items()}})
    if dist.get_rank() == 0:
        torch.save(result, out)
    dist.destroy_process_group()
""").format(SEED=SEED, B=B, S_TEXT=S_TEXT)


def _init_run(mp: int, tmp_path, sliced: bool = False) -> dict:
    out = tmp_path / "init.pt"
    _launch(["-c", INIT_WORKER, str(mp), str(out), "sliced" if sliced else "whole"], 2)
    return torch.load(out)


@pytest.mark.parametrize("dp,mp,sliced", [(2, 1, False), (1, 2, False), (1, 2, True)],
                         ids=["data2", "model2", "model2-unit-draws"])
def test_sharded_init_equals_init_params(dp, mp, sliced, tmp_path):
    """Leaf by leaf, and (``sliced``) with every stacked leaf drawn unit by
    unit in both inits, as internvl2-76b's 70 GiB leaves are at 80 layers."""
    got = _init_run(mp, tmp_path, sliced)
    assert got["leaves"] == len(model_specs(_narrow_internvl2()))
    assert got["unequal"] == []
    assert got["whole"] == []          # no shard keeps its whole leaf alive
    # "embed" leaves split on "data", "heads"/"ffn"/"vocab" leaves on "model"
    assert len(got["split"]) >= 4, got["split"]


def test_unit_draws_equal_the_stacked_units(monkeypatch):
    """``init_params`` with every stacked leaf drawn unit by unit into one
    tensor equals the units drawn in the same order and stacked."""
    import repro_torch.models.params as params_mod

    monkeypatch.setattr(params_mod, "SLICED_DRAW_BYTES", 0)
    specs = model_specs(_narrow_internvl2())
    got = params_mod.init_params(specs, SEED, device="cpu")
    gen = torch.Generator().manual_seed(SEED)
    units = 0
    for k, s in sorted(specs.items()):
        unit = params_mod._unit_slices(s)
        if unit is None:
            want = params_mod._init_leaf(gen, s, torch.device("cpu"))
        else:
            units += 1
            want = torch.stack([params_mod._init_leaf(gen, unit, torch.device("cpu"))
                                for _ in range(s.shape[0])])
        assert got[k].dtype == want.dtype and torch.equal(got[k], want), k
    assert units > 0


def test_model_split_prefill_matches_jax(tmp_path):
    """The (1, 2) prefill program against ``repro.models.lm.prefill`` on the
    same weights (``init_params`` in f32, equal to the ranks' leaf-wise
    init by the test above) carried as numpy arrays."""
    import jax.numpy as jnp

    from repro.models import base as JB
    from repro.models import lm as JL
    from repro.models.config import Segment as JSegment

    got = _init_run(2, tmp_path)
    assert got["unequal"] == []
    assert any("Shard" in p for p in got["placements"].values())
    cfg = _narrow_internvl2()
    jcfg = dataclasses.replace(JB.get_config("internvl2_76b").reduced(),
                               segments=(JSegment(("attn",), 2),))
    params = init_params(model_specs(cfg), SEED, device="cpu")
    jp = {k: jnp.asarray(v.float().numpy()) for k, v in params.items()}
    S = S_TEXT + cfg.num_patches
    j_logits, j_cache, j_len = JL.prefill(jcfg, jp, jnp.asarray(got["tokens"].numpy()), S,
                                          jnp.asarray(got["patches"].numpy()))
    assert got["cache_len"] == int(j_len) == S
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(j_logits), **TOL)
    assert sorted(got["cache"]) == sorted(j_cache)
    for k, v in j_cache.items():
        np.testing.assert_allclose(got["cache"][k].float().numpy(), np.asarray(v, np.float32),
                                   err_msg=k, **TOL)


BF16_WORKER = textwrap.dedent("""
    import dataclasses, sys, torch, torch.distributed as dist
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.models.base import ShapeCell, get_config
    from repro_torch.models.config import Segment
    from repro_torch.models.params import init_params

    arch, out = sys.argv[1], sys.argv[2]
    mesh = make_host_mesh(model_parallel=2, device="cpu")
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, segments=(Segment(cfg.segments[0].pattern, 2),))
    params = init_params(steps.model_specs(cfg), {SEED}, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), dtype=torch.int32,
                           generator=torch.Generator().manual_seed({SEED}))
    want, want_cache, _ = lm.prefill(cfg, params, tokens, 32)
    prog = steps.build_prefill_program(cfg, ShapeCell("p", "prefill", 32, 4), mesh)
    logits, cache, _ = prog.run(params, {{"tokens": tokens}})
    got = {{"logits": logits.full_tensor(), "want": want,
           "cache": {{k: v.full_tensor() for k, v in cache.items()}}, "want_cache": want_cache}}
    if dist.get_rank() == 0:
        torch.save(got, out)
    dist.destroy_process_group()
""").format(SEED=SEED)


@pytest.mark.parametrize("arch", ["mamba2_370m", "recurrentgemma_9b", "yi_6b",
                                  "mixtral_8x22b", "olmoe_1b_7b"])
def test_model_split_prefill_is_bit_equal_in_bf16(arch, tmp_path):
    """The (1, 2) prefill program on bf16 weights bit-equal to the unsharded
    port at 2 units: the vocab-split lookup summed at once, the
    row-parallel products summed in f32 (``layers/common.py``
    ``_contracted``) and, for the MoE configs (reduced: 8 experts top-2,
    4 a rank; mixtral's window 16), the experts' partial combines summed
    in f32 (``layers/moe.py`` ``_experts``), so no bf16 rounding is added
    by the split."""
    out = tmp_path / "bf16.pt"
    _launch(["-c", BF16_WORKER, arch, str(out)], 2)
    got = torch.load(out)
    assert torch.equal(got["logits"], got["want"])
    for k, v in got["want_cache"].items():
        assert torch.equal(got["cache"][k], v), k


# -- the train driver on two ranks --------------------------------------------

TRAIN_WORKER = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import train
    out = train.main(sys.argv[1:])
    print("RESULT " + json.dumps({"start_step": out["start_step"], "losses": out["losses"],
                                  "checkpoints": [str(p) for p in out["checkpoints"]]}))
""")


def _train(argv) -> list:
    outs = _launch(["-c", TRAIN_WORKER, *argv], 2)
    runs = []
    for stdout, _ in outs:
        lines = stdout.strip().splitlines()
        runs.append({"result": json.loads(lines[-1][len("RESULT "):]), "printed": lines[:-1]})
    return runs


def test_train_driver_on_two_ranks_checkpoints_on_rank_0_and_resumes(tmp_path):
    argv = ["--device", "cpu", "--arch", "yi_6b", "--steps", "6", "--batch", "4",
            "--seq", "32", "--lr", "5e-3", "--ckpt-dir", str(tmp_path / "ckpt"),
            "--ckpt-every", "3"]
    lead, other = _train(argv)
    for run in (lead, other):
        r = run["result"]
        assert r["start_step"] == 0 and len(r["losses"]) == 6
        assert all(np.isfinite(r["losses"]))
        assert r["losses"][-1] < r["losses"][0]
    assert lead["result"]["losses"] == other["result"]["losses"]
    assert any("ranks=2" in line for line in lead["printed"])
    assert other["printed"] == [] and other["result"]["checkpoints"] == []
    assert [pathlib.Path(p).name for p in lead["result"]["checkpoints"]] == \
        ["step_00000003", "step_00000006"]
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == \
        ["step_00000003", "step_00000006"]

    lead, other = _train(argv[:5] + ["8"] + argv[6:] + ["--resume"])
    for run in (lead, other):
        assert run["result"]["start_step"] == 6 and len(run["result"]["losses"]) == 2
        assert all(np.isfinite(run["result"]["losses"]))
    assert any("resumed from" in line for line in lead["printed"])
    assert other["printed"] == []
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == \
        ["step_00000003", "step_00000006", "step_00000008"]


# -- the four-card script ------------------------------------------------------

@pytest.mark.skipif(torch.cuda.is_available(), reason="the script's no-CUDA exit")
def test_four_card_script_without_cuda_exits_2_with_one_line():
    out = subprocess.run([sys.executable, str(SCRIPT), "--world", "4"], env=_env(),
                         text=True, capture_output=True, timeout=SPAWN_TIMEOUT)
    assert out.returncode == 2
    assert out.stdout == ""
    assert len(out.stderr.strip().splitlines()) == 1, out.stderr


def test_four_card_script_rehearses_on_four_gloo_ranks():
    """``--world 4 --cpu``: the script's ranks on four gloo processes at the
    configs' reduced widths, parts (b)-(e) with their gates (the launch and
    peak gates need the card); it exits 0 and its last line says so."""
    out = subprocess.run([sys.executable, str(SCRIPT), "--world", "4", "--cpu"],
                         env=_env(), text=True, capture_output=True, timeout=600)
    assert out.returncode == 0, (out.stdout + out.stderr)[-4000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])["four_cards"]
    assert summary["failed"] == [] and summary["parts"] == ["b", "c", "d", "e"]
    ranks = summary["ranks"]
    assert [r["rendezvous"]["rank"] for r in ranks] == [0, 1, 2, 3]
    lead = ranks[0]
    for mesh in ("(4, 1)", "(1, 4)"):
        assert lead["b"][mesh]["beyond_limit"] == {}
    assert lead["d"]["init_bit_equal_leaves"] > 0 and lead["d"]["full"]["finite"]
    moe = lead["e"]
    assert moe["init_bit_equal_leaves"] > 0 and moe["full"]["finite"]
    assert moe["tempered"]["worst"][1] <= 2e-2     # the script's REL_L2
    assert len(moe["full"]["decode_ms"]) == 4


def test_four_card_script_runs_part_e_at_2_layers_on_one_gloo_rank():
    """``--world 1 --cpu --parts e2``: part (e) at 2 layers on a (1, 1) mesh
    (``chip_smoke.py``'s phase 22 runs it so on one card): the leaf-wise
    init, and the prefill, cache and one decode step bit-equal to the
    unsharded port for each set of weights; part (e) at full depth is
    named among the parts not run."""
    out = subprocess.run([sys.executable, str(SCRIPT), "--world", "1", "--cpu",
                          "--parts", "e2"], env=_env(), text=True, capture_output=True,
                         timeout=SPAWN_TIMEOUT)
    assert out.returncode == 0, (out.stdout + out.stderr)[-4000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])["four_cards"]
    assert summary["failed"] == [] and summary["parts"] == ["e2"]
    assert "e" in summary["skipped"]
    moe = summary["ranks"][0]["e"]
    assert moe["init_bit_equal_leaves"] == len(model_specs(
        dataclasses.replace(get_config("mixtral_8x22b").reduced(),
                            segments=(Segment(("moe",), 2),))))
    for label in ("seeded", "tempered"):
        assert moe[label]["prefill_bit_equal"] and moe[label]["decode_bit_equal"], label
        assert moe[label]["dropped"] == moe[label]["unsharded_dropped"]
    assert "full" not in moe


def test_four_card_script_imports_no_jax():
    names = set()
    for node in ast.walk(ast.parse(SCRIPT.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "repro"}, names
    assert "repro_torch" in names or "torch" in names
