"""The port's cell programs (``launch/steps.py``) on the CPU.

On a one-rank CPU mesh (``make_host_mesh``, a gloo group in this process)
the train, prefill and decode programs run the model on DTensors and must
give exactly what the unsharded port gives, for reduced yi-6b, olmoe-1b-7b,
mamba2-370m, recurrentgemma-9b and whisper-medium: the train program's
state after two steps against ``train_step``'s, bit for bit; the prefill
program's logits and cache against ``lm.prefill`` (whisper:
``encdec_prefill``) and one decode step against ``lm.decode_step``.

Two spawned gloo processes then run the train program at (data=2, model=1)
and (data=1, model=2) on reduced yi-6b and olmoe-1b-7b: the loss and every
leaf of the state after one step within 2e-2 relative L2 of the unsharded
step (the JAX package's bf16 tolerance: the shards sum in another order).
Each process is joined with its own timeout, then killed.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import synthetic_batches
from repro_torch.models import lm
from repro_torch.models.base import ShapeCell, get_config
from repro_torch.models.encdec import encdec_prefill
from repro_torch.models.params import init_params
from repro_torch.train.optimizer import AdamWConfig, init_state

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["yi_6b", "olmoe_1b_7b", "mamba2_370m", "recurrentgemma_9b", "whisper_medium",
         "mixtral_8x22b"]
ADAMW = AdamWConfig(lr=1e-3, warmup_steps=2)
B, S = 4, 32
REL_L2 = 2e-2
SPAWN_TIMEOUT = 240


@pytest.fixture(scope="module")
def mesh():
    """A one-rank (1, 1) CPU mesh; the group is destroyed afterwards."""
    made = not dist.is_initialized()
    m = make_host_mesh(model_parallel=1, device="cpu")
    yield m
    if made:
        dist.destroy_process_group()


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _batches(cfg, n):
    data = synthetic_batches(cfg, B, S)
    return [{k: torch.from_numpy(v) for k, v in next(data).items()} for _ in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_program_equals_train_step(arch, mesh):
    cfg = get_config(arch).reduced()
    specs = steps.model_specs(cfg)
    prog = steps.build_train_program(cfg, ShapeCell("t", "train", S, B), mesh, adamw=ADAMW)
    params = init_params(specs, seed=0, device="cpu")
    ref, st = init_state(params), init_state(params)
    for batch in _batches(cfg, 2):
        ref, ref_metrics = steps.train_step(cfg, ref, batch, ADAMW)
        st, metrics = prog.run(st, batch)
        assert torch.equal(_full(metrics["loss"]), ref_metrics["loss"])
    assert st.step == ref.step == 2
    for part in ("params", "m", "v"):
        got, want = getattr(st, part), getattr(ref, part)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(_full(got[k]), want[k]), (part, k)


def _prompt(cfg, n=S):
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, n), generator=g,
                                     dtype=torch.int32)}
    if cfg.frontend == "audio":
        batch["frames"] = torch.randn(B, cfg.encoder_seq, cfg.d_model,
                                      generator=g).to(torch.bfloat16)
    return batch


def _prefill(cfg, params, batch, cache_size):
    if cfg.family == "audio":
        logits, cache, clen, _ = encdec_prefill(cfg, params, batch["frames"],
                                                batch["tokens"], cache_size)
        return logits, cache, clen
    return lm.prefill(cfg, params, batch["tokens"], cache_size)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_programs_equal_the_port(arch, mesh):
    cfg = get_config(arch).reduced()
    params = init_params(steps.model_specs(cfg), seed=0, device="cpu")
    batch = _prompt(cfg)
    prog = steps.build_prefill_program(cfg, ShapeCell("p", "prefill", S, B), mesh)
    logits, cache, clen = prog.run(params, batch)
    want_logits, want_cache, want_clen = _prefill(cfg, params, batch, S)
    assert clen == want_clen == S
    assert torch.equal(_full(logits), want_logits)
    assert cache.keys() == want_cache.keys()
    for k in want_cache:
        assert torch.equal(_full(cache[k]), want_cache[k]), k

    # one decode step after a prompt one token shorter
    head = {k: (v[:, :S - 1] if k == "tokens" else v) for k, v in batch.items()}
    _, ref_cache, n = _prefill(cfg, params, head, S)
    # a copy made outside inference mode: the program updates it in place
    dec_cache = {k: v.clone() for k, v in _prefill(cfg, params, head, S)[1].items()}
    nxt = batch["tokens"][:, -1:]
    want_logits, want_cache = lm.decode_step(cfg, params, ref_cache, n, nxt)
    dprog = steps.build_decode_program(cfg, ShapeCell("d", "decode", S, B), mesh)
    logits, cache = dprog.run(params, dec_cache, n, nxt)
    assert torch.equal(_full(logits), want_logits)
    for k in want_cache:
        assert torch.equal(_full(cache[k]), want_cache[k]), k


def test_cell_program_shapes(mesh):
    cfg = get_config("yi_6b").reduced()
    for kind in ("train", "prefill", "decode"):
        prog = steps.build_cell_program(cfg, ShapeCell(kind, kind, S, B), mesh)
        assert len(prog.args) == len(prog.in_placements)
        assert prog.mesh is mesh
    with pytest.raises(ValueError):
        steps.build_cell_program(cfg, ShapeCell("x", "other", S, B), mesh)


# --- two ranks --------------------------------------------------------------

WORKER = textwrap.dedent("""
    import sys, torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import steps
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.models.base import ShapeCell, get_config
    from repro_torch.models.params import init_params
    from repro_torch.train.optimizer import AdamWConfig, init_state

    rank, store, arch, dp, mp, out = sys.argv[1:]
    rank, dp, mp = int(rank), int(dp), int(mp)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=dp * mp)
    mesh = init_device_mesh("cpu", (dp, mp), mesh_dim_names=("data", "model"))
    cfg = get_config(arch).reduced()
    prog = steps.build_train_program(cfg, ShapeCell("t", "train", {S}, {B}), mesh,
                                     adamw=AdamWConfig(lr=1e-3, warmup_steps=2))
    state = init_state(init_params(steps.model_specs(cfg), seed=0, device="cpu"))
    data = synthetic_batches(cfg, {B}, {S})
    batch = {{k: torch.from_numpy(v) for k, v in next(data).items()}}
    state, metrics = prog.run(state, batch)
    full = {{f"{{p}}/{{k}}": v.full_tensor() for p in ("params", "m", "v")
            for k, v in getattr(state, p).items()}}
    full["loss"] = metrics["loss"].full_tensor()
    if rank == 0:
        torch.save(full, out)
    dist.destroy_process_group()
""").format(S=S, B=B)


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm().clamp(min=1e-30))


@pytest.mark.parametrize("dp,mp", [(2, 1), (1, 2)], ids=["data2", "model2"])
@pytest.mark.parametrize("arch", ["yi_6b", "olmoe_1b_7b"])
def test_two_rank_train_step_matches_unsharded(arch, dp, mp, tmp_path):
    out = tmp_path / "state.pt"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(tmp_path / "store"),
                               arch, str(dp), str(mp), str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(dp * mp)]
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

    got = torch.load(out)
    cfg = get_config(arch).reduced()
    state = init_state(init_params(steps.model_specs(cfg), seed=0, device="cpu"))
    want, metrics = steps.train_step(cfg, state, _batches(cfg, 1)[0], ADAMW)
    assert _rel_l2(got["loss"], metrics["loss"]) < REL_L2
    for p in ("params", "m", "v"):
        for k, v in getattr(want, p).items():
            assert _rel_l2(got[f"{p}/{k}"], v) < REL_L2, (p, k)
