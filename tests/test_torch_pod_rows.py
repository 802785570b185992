"""Serving programs on a multi-pod mesh whose rows divide "data" but not
"pod" x "data" (``launch/steps.py`` ``serving_mesh``), on the CPU.

The plan (``dist/sharding.py``) replicates such rows on every card and
sends a ``sharding_fallback`` event, as the JAX package's does; the
program instead runs on the pod-local (data, model) submesh, where the
rows split over "data".

* On a fake (pod 2, data 32, model 8) group (a subprocess, as the dry
  run's tests): a reduced yi-6b prefill cell of 32 rows gets its rows as
  ``Shard(0)`` on "data" of the submesh and sends no fallback event, and
  its dry-run peak a card is within 5% of the same cell's on (data 32,
  model 8), its flops a card equal; a decode cell of 32 rows takes the
  submesh too; a train cell of 64 rows and a prefill cell of 64 are placed
  on the whole mesh exactly as the plan says; a one-row cell stays on the
  whole mesh, replicated, with the plan's fallback event.
* Four spawned gloo ranks on (pod 2, data 2, model 1) run
  ``build_prefill_program`` on 2 rows: the logits and every cache leaf of
  both pods within 2e-2 relative L2 of the unsharded port (the two-rank
  tests' rule).  Each process is joined with its own timeout, then killed.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.models.base import get_config
from repro_torch.models.params import init_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 600
SPAWN_TIMEOUT = 240
REL_L2 = 2e-2
MULTI = {"pod": 2, "data": 32, "model": 8}
SINGLE = {"data": 32, "model": 8}

FAKE = textwrap.dedent("""
    import json
    from repro_torch.dist.context import mesh_axes
    from repro_torch.dist.sharding import on_fallback
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.base import ShapeCell, get_config

    MULTI, SINGLE = {MULTI}, {SINGLE}
    cfg = get_config("yi_6b").reduced()
    events = []
    on_fallback(events.append)

    def described(p):
        return [repr(x) for x in p] if p is not None else None

    out = {{"programs": {{}}}}
    with dryrun.fake_world(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        for kind, rows in (("prefill", 32), ("decode", 32), ("train", 64), ("prefill", 64),
                           ("decode", 1)):
            del events[:]
            prog = steps.build_cell_program(cfg, ShapeCell(kind, kind, 64, rows), mesh)
            sent = len(events)
            batch = prog.in_placements[1] if kind != "decode" else {{"tokens": prog.in_placements[3]}}
            ref = steps._placements(
                steps.input_pspecs(prog.args[1] if kind != "decode" else
                                   {{"tokens": prog.args[3]}}, mesh), mesh)
            out["programs"][f"{{kind}}/{{rows}}"] = {{
                "mesh": mesh_axes(prog.mesh),
                "whole": prog.mesh is mesh,
                "inputs": {{k: described(v) for k, v in batch.items()}},
                "plan_inputs": {{k: described(v) for k, v in ref.items()}},
                "events": sent}}
    cell = ShapeCell("p", "prefill", 64, 32)
    del events[:]
    out["multi"] = dryrun.run_cell(cfg, cell, mesh_shape=MULTI)
    out["multi_events"] = len(events)
    out["single"] = dryrun.run_cell(cfg, cell, mesh_shape=SINGLE)
    print("RESULT " + json.dumps(out))
""").format(MULTI=MULTI, SINGLE=SINGLE)


@pytest.fixture(scope="module")
def fake():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    try:
        proc = subprocess.run([sys.executable, "-c", FAKE], env=env, capture_output=True,
                              text=True, timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the fake-group run did not finish within {TIMEOUT} s")
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")), None)
    assert proc.returncode == 0 and line, (proc.stdout + proc.stderr)[-4000:]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_rows_split_over_data_on_the_pod_submesh(fake, kind):
    prog = fake["programs"][f"{kind}/32"]
    assert prog["mesh"] == SINGLE and not prog["whole"]
    assert prog["events"] == 0
    for placements in prog["inputs"].values():
        assert placements == ["Shard(dim=0)", "Replicate()"]


@pytest.mark.parametrize("kind, rows", [("train", 64), ("prefill", 64)])
def test_rows_that_divide_pod_and_data_stay_on_the_whole_mesh(fake, kind, rows):
    prog = fake["programs"][f"{kind}/{rows}"]
    assert prog["whole"] and prog["mesh"] == MULTI
    assert prog["events"] == 0
    assert prog["inputs"] == prog["plan_inputs"]
    for placements in prog["inputs"].values():
        assert placements == ["Shard(dim=0)", "Shard(dim=0)", "Replicate()"]


def test_one_row_stays_replicated_on_the_whole_mesh(fake):
    prog = fake["programs"]["decode/1"]
    assert prog["whole"] and prog["mesh"] == MULTI
    assert prog["events"] >= 1  # the plan's fallback, as the reference's
    assert prog["inputs"]["tokens"] == ["Replicate()"] * 3


def test_dry_run_on_the_submesh_matches_the_single_mesh(fake):
    multi, single = fake["multi"], fake["single"]
    assert multi["status"] == single["status"] == "ok"
    assert fake["multi_events"] == 0
    assert multi["chips"] == 512 and single["chips"] == 256
    assert multi["program_mesh"] == SINGLE
    peak_m = multi["memory"]["peak_bytes_per_chip"]
    peak_s = single["memory"]["peak_bytes_per_chip"]
    assert abs(peak_m - peak_s) <= 0.05 * peak_s
    assert multi["roofline"]["flops_per_chip"] == single["roofline"]["flops_per_chip"]
    assert multi["roofline"]["collective_counts"] == single["roofline"]["collective_counts"]


def test_serving_mesh_leaves_a_mesh_without_pods():
    assert steps.serving_mesh({"data": 2, "model": 1}, 3) == {"data": 2, "model": 1}


# --- four ranks ---------------------------------------------------------------

S = 32
WORKER = textwrap.dedent("""
    import json, sys, torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist.sharding import on_fallback
    from repro_torch.launch import steps
    from repro_torch.models.base import ShapeCell, get_config
    from repro_torch.models.params import init_params

    rank, store, arch, out = sys.argv[1:]
    rank = int(rank)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2, 1), mesh_dim_names=("pod", "data", "model"))
    events = []
    on_fallback(events.append)
    cfg = get_config(arch).reduced()
    prog = steps.build_prefill_program(cfg, ShapeCell("p", "prefill", {S}, 2), mesh)
    params = init_params(steps.model_specs(cfg), seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, {S}), generator=g, dtype=torch.int32)
    logits, cache, clen = prog.run(params, {{"tokens": tokens}})
    full = {{"logits": logits.full_tensor()}}
    full.update({{f"cache/{{k}}": v.full_tensor() for k, v in cache.items()}})
    local = logits.to_local().shape[0]
    if rank in (0, 2):  # one rank of each pod
        torch.save(full, out + f".{{rank}}")
        with open(out + f".{{rank}}.json", "w") as f:
            json.dump({{"mesh": list(prog.mesh.mesh_dim_names), "events": len(events),
                       "clen": int(clen), "local_rows": local,
                       "tokens": [repr(p) for p in prog.in_placements[1]["tokens"]]}}, f)
    dist.destroy_process_group()
""").format(S=S)


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm().clamp(min=1e-30))


@pytest.mark.parametrize("arch", ["yi_6b", "mamba2_370m"])
def test_four_rank_prefill_splits_rows_and_matches_unsharded(arch, tmp_path):
    out = tmp_path / "out.pt"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(tmp_path / "store"),
                               arch, str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail(f"a rank did not finish within {SPAWN_TIMEOUT} s")
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]

    cfg = get_config(arch).reduced()
    params = init_params(steps.model_specs(cfg), seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, S), generator=g, dtype=torch.int32)
    want_logits, want_cache, want_clen = lm.prefill(cfg, params, tokens, S)
    for rank in (0, 2):
        info = json.loads(pathlib.Path(f"{out}.{rank}.json").read_text())
        assert info["mesh"] == ["data", "model"]
        assert info["events"] == 0
        assert info["local_rows"] == 1  # 2 rows over data = 2
        assert info["tokens"] == ["Shard(dim=0)", "Replicate()"]
        assert info["clen"] == int(want_clen) == S
        got = torch.load(f"{out}.{rank}")
        assert _rel_l2(got["logits"], want_logits) < REL_L2
        assert {k[len("cache/"):] for k in got if k.startswith("cache/")} == want_cache.keys()
        for k, v in want_cache.items():
            assert got[f"cache/{k}"].shape == v.shape, k
            assert _rel_l2(got[f"cache/{k}"], v) < REL_L2, k
