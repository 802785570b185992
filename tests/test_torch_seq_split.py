"""The sequence split at the unit boundary (``models/lm.py`` ``UNIT_AXES``,
the reference's ``constrain(h, "batch", "seq_model", None)``) on two gloo
ranks on the CPU, started as a launcher starts them (``make_host_mesh``
joins them at (data=1, model=2)).

* The train program of reduced yi-6b at 3 units keeps, in every remat
  region (each unit and each block of ``xent_loss``), an input split on
  "model": S / 2 rows a rank, ``Shard(1)``.  A sequence of odd length
  does not divide by 2 and stays whole (S rows, no ``Shard(1)``).  Both
  losses within 2e-2 relative L2 of the unsharded ``train_step``
  (``tests/test_torch_steps.py``'s rule).
* The prefill program of reduced whisper-medium: the encoder, which runs
  through ``lm.backbone``, leaves its last unit split (12 of its 24 frames
  a rank), and the logits and every cache leaf stay within 2e-2 relative
  L2 of the unsharded ``encdec_prefill``.

Each rank is joined with its own timeout, then killed.
"""
import dataclasses
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.launch import steps
from repro_torch.launch.train import synthetic_batches
from repro_torch.models.base import get_config
from repro_torch.models.config import Segment
from repro_torch.models.encdec import encdec_prefill
from repro_torch.models.params import init_params
from repro_torch.train.optimizer import AdamWConfig, init_state

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 240
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT")
REL_L2 = 2e-2
ADAMW = AdamWConfig(lr=1e-3, warmup_steps=2)
B, UNITS, SEED = 4, 3, 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(argv, world: int = 2) -> None:
    """``argv`` started ``world`` times as a launcher starts its ranks; every
    rank must exit 0."""
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, *argv],
        env={**env, "RANK": str(r), "WORLD_SIZE": str(world), "LOCAL_RANK": str(r),
             "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
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


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm().clamp(min=1e-30))


# -- the train program's remat inputs -----------------------------------------

TRAIN_WORKER = textwrap.dedent("""
    import dataclasses, sys, torch, torch.distributed as dist, torch.utils.checkpoint
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.models.base import ShapeCell, get_config
    from repro_torch.models.config import Segment
    from repro_torch.models.params import init_params
    from repro_torch.train.optimizer import AdamWConfig, init_state

    S, out = int(sys.argv[1]), sys.argv[2]
    kept = []
    plain = torch.utils.checkpoint.checkpoint

    def recording(fn, x, *args, **kw):
        kept.append({{"rows": x.to_local().shape[1], "global_rows": x.shape[1],
                      "split": any(p.is_shard(1) for p in x.placements)}})
        return plain(fn, x, *args, **kw)

    torch.utils.checkpoint.checkpoint = recording
    mesh = make_host_mesh(model_parallel=2, device="cpu")
    cfg = get_config("yi_6b").reduced()
    cfg = dataclasses.replace(cfg, segments=(Segment(cfg.segments[0].pattern, {UNITS}),))
    prog = steps.build_train_program(cfg, ShapeCell("t", "train", S, {B}), mesh,
                                     adamw=AdamWConfig(lr=1e-3, warmup_steps=2))
    state = init_state(init_params(steps.model_specs(cfg), seed={SEED}, device="cpu"))
    batch = {{k: torch.from_numpy(v) for k, v in next(synthetic_batches(cfg, {B}, S)).items()}}
    state, metrics = prog.run(state, batch)
    if dist.get_rank() == 0:
        torch.save({{"kept": kept, "loss": metrics["loss"].full_tensor()}}, out)
    dist.destroy_process_group()
""").format(UNITS=UNITS, B=B, SEED=SEED)


@pytest.mark.parametrize("S", [32, 33], ids=["divides", "odd"])
def test_train_program_keeps_split_unit_inputs(S, tmp_path):
    out = tmp_path / "kept.pt"
    _launch(["-c", TRAIN_WORKER, str(S), str(out)])
    got = torch.load(out)
    kept = got["kept"]
    assert len(kept) == UNITS + 1  # the units, then xent_loss's one block
    split = S % 2 == 0
    for rec in kept:
        assert rec["global_rows"] == S
        assert rec["rows"] == (S // 2 if split else S), rec
        assert rec["split"] is split, rec

    cfg = get_config("yi_6b").reduced()
    cfg = dataclasses.replace(cfg, segments=(Segment(cfg.segments[0].pattern, UNITS),))
    state = init_state(init_params(steps.model_specs(cfg), seed=SEED, device="cpu"))
    batch = {k: torch.from_numpy(v) for k, v in next(synthetic_batches(cfg, B, S)).items()}
    _, metrics = steps.train_step(cfg, state, batch, ADAMW)
    assert _rel_l2(got["loss"], metrics["loss"]) < REL_L2


# -- whisper's encoder under the prefill program -------------------------------

PREFILL_WORKER = textwrap.dedent("""
    import sys, torch, torch.distributed as dist
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import encdec
    from repro_torch.models.base import ShapeCell, get_config
    from repro_torch.models.params import init_params

    out = sys.argv[1]
    exits = []
    plain = encdec.backbone

    def recording(*args, **kw):
        x, aux = plain(*args, **kw)
        exits.append({{"prefix": kw.get("key_prefix", "seg"), "rows": x.to_local().shape[1],
                       "split": any(p.is_shard(1) for p in x.placements)}})
        return x, aux

    encdec.backbone = recording
    mesh = make_host_mesh(model_parallel=2, device="cpu")
    cfg = get_config("whisper_medium").reduced()
    params = init_params(steps.model_specs(cfg), {SEED}, device="cpu")
    g = torch.Generator().manual_seed({SEED})
    batch = {{"tokens": torch.randint(0, cfg.vocab_size, ({B}, 16), generator=g,
                                      dtype=torch.int32),
              "frames": torch.randn({B}, cfg.encoder_seq, cfg.d_model,
                                    generator=g).to(torch.bfloat16)}}
    prog = steps.build_prefill_program(cfg, ShapeCell("p", "prefill", 16, {B}), mesh)
    logits, cache, clen = prog.run(params, batch)
    got = {{"exits": exits, "batch": batch, "logits": logits.full_tensor(), "clen": clen,
           "cache": {{k: v.full_tensor() for k, v in cache.items()}}}}
    if dist.get_rank() == 0:
        torch.save(got, out)
    dist.destroy_process_group()
""").format(B=B, SEED=SEED)


def test_whisper_prefill_splits_the_encoder_and_matches_one_rank(tmp_path):
    out = tmp_path / "prefill.pt"
    _launch(["-c", PREFILL_WORKER, str(out)])
    got = torch.load(out)
    cfg = get_config("whisper_medium").reduced()
    assert [e["prefix"] for e in got["exits"]] == ["enc"]
    assert got["exits"][0]["rows"] == cfg.encoder_seq // 2 and got["exits"][0]["split"]

    params = init_params(steps.model_specs(cfg), SEED, device="cpu")
    batch = got["batch"]
    logits, cache, clen, _ = encdec_prefill(cfg, params, batch["frames"], batch["tokens"], 16)
    assert got["clen"] == clen == 16
    assert _rel_l2(got["logits"], logits) < REL_L2
    assert got["cache"].keys() == cache.keys()
    for k, v in cache.items():
        assert _rel_l2(got["cache"][k], v) < REL_L2, k
