"""The port's dry run (``launch/dryrun.py``) on the CPU, in a subprocess
with a timeout (it makes a fake process group of its own).

``run_cell`` on reduced yi-6b and olmoe-1b-7b cells over fake (2, 2) and
(32, 8) meshes returns the JAX dry run's record keys (read from the
reference's source) with status "ok"; a train cell's traced flops over the
whole mesh are at least the analytic ``model_flops`` (6 N D, which a step
with remat and attention exceeds; a prefill computes the logits of its last
position only, so 2 N D overstates it); a train cell's peak bytes per
card fall from a (1, 1) mesh to a (2, 1) one, and on a (1, 2) mesh they are
lower with the residual stream's sequence split on "model" between units
(``models/lm.py`` ``UNIT_AXES``) than with it patched back to whole; and no
process group is left behind.  A default group that already exists makes
the dry run refuse.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 600

SCRIPT = textwrap.dedent("""
    import json, torch.distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.models.base import ShapeCell, get_config

    out = {}
    for arch in ("yi_6b", "olmoe_1b_7b"):
        cfg = get_config(arch).reduced()
        for kind in ("train", "prefill", "decode"):
            cell = ShapeCell(kind, kind, 64, 8)
            for mesh in ({"data": 2, "model": 2}, {"data": 32, "model": 8}):
                key = f"{arch}/{kind}/" + "x".join(map(str, mesh.values()))
                out[key] = dryrun.run_cell(cfg, cell, mesh_shape=mesh)
    cfg = get_config("yi_6b").reduced()
    for mesh in ({"data": 1, "model": 1}, {"data": 2, "model": 1}):
        key = "peak/" + "x".join(map(str, mesh.values()))
        out[key] = dryrun.run_cell(cfg, ShapeCell("t", "train", 64, 8), mesh_shape=mesh)
    from repro_torch.models import lm
    split = lm.UNIT_AXES
    for name, axes in (("split", split), ("whole", ("batch", None, None))):
        lm.UNIT_AXES = axes
        out["seq/" + name] = dryrun.run_cell(cfg, ShapeCell("t", "train", 64, 8),
                                             mesh_shape={"data": 1, "model": 2})
    lm.UNIT_AXES = split
    out["group_left"] = dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        dryrun.run_cell(cfg, ShapeCell("t", "train", 64, 8), mesh_shape={"data": 1})
        out["refused"] = False
    except RuntimeError:
        out["refused"] = True
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out))
""")


def _reference_keys():
    """The keys of the JAX dry run's "ok" record (its run_cell's return)."""
    tree = ast.parse((ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    ret = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Return)
               and isinstance(n.value, ast.Dict)
               and any(getattr(k, "value", None) == "memory" for k in n.value.keys))
    keys = {k.value for k in ret.keys}
    mem = next(v for k, v in zip(ret.keys, ret.values) if k.value == "memory")
    return keys, {k.value for k in mem.keys}


@pytest.fixture(scope="module")
def records():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    try:
        proc = subprocess.run([sys.executable, "-c", SCRIPT], env=env, capture_output=True,
                              text=True, timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the dry run did not finish within {TIMEOUT} s")
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")), None)
    assert proc.returncode == 0 and line, (proc.stdout + proc.stderr)[-4000:]
    return json.loads(line[len("RESULT "):])


def test_records_have_the_reference_keys(records):
    keys, mem_keys = _reference_keys()
    cells = [k for k in records if k.count("/") == 2]
    assert len(cells) == 12
    for key in cells:
        rec = records[key]
        assert rec["status"] == "ok", key
        assert keys <= rec.keys(), (key, keys - rec.keys())
        assert mem_keys <= rec["memory"].keys()
        assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
        assert rec["chips"] == (4 if key.endswith("2x2") else 256)


def test_traced_flops_cover_the_model_flops(records):
    for key in (k for k in records if k.count("/") == 2):
        rec = records[key]
        assert rec["roofline"]["flops_per_chip"] > 0, key
        if rec["kind"] == "train":
            assert rec["hlo_flops_total"] >= rec["model_flops_total"] > 0, key


def test_sharding_lowers_the_peak_per_card(records):
    one, two = records["peak/1x1"], records["peak/2x1"]
    assert two["memory"]["peak_bytes_per_chip"] < one["memory"]["peak_bytes_per_chip"]
    assert one["roofline"]["collective_bytes_per_chip"] == 0


def test_sequence_split_lowers_the_peak_per_card(records):
    split, whole = records["seq/split"], records["seq/whole"]
    assert split["status"] == whole["status"] == "ok"
    assert split["memory"]["peak_bytes_per_chip"] < whole["memory"]["peak_bytes_per_chip"]


def test_no_group_left_and_refusal(records):
    assert records["group_left"] is False
    assert records["refused"] is True
