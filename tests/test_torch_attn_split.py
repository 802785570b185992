"""The attention core's query rows split on "model" where the KV heads do
not divide it (``layers/attention.py`` ``_row_split``, the reference's
``_flash_fwd`` residuals on ``"seq_model"``), on gloo ranks on the CPU
started as a launcher starts them (``make_host_mesh`` joins them at
(data=1, model=M)).

* The train program of reduced recurrentgemma-9b (1 KV head) at (1, 2),
  reduced yi-6b and chatglm3-6b (2 KV heads; chatglm3 rotates half of
  each head) at (1, 4), one step:
  - computed in bf16: the loss and every leaf of params, m and v within
    2e-2 relative L2 of the unsharded ``train_step``
    (``tests/test_torch_steps.py``'s rule), but for the two leaves of
    ``KNOWN_DISTANCE``, held within 3e-2 (recurrentgemma-9b's (1, 2)
    program puts v of each ``rglru/w_r`` 2.14e-2 and 2.76e-2 away with the
    whole core on every rank too, and under 1e-4 in f32: ROADMAP section 3,
    item 2); and every leaf within 2e-2 of the same program with the whole
    core on every rank (``_row_split`` patched to it);
  - computed in f32: every leaf within ``F32_REL_L2`` of ``train_step``
    in f32, where rounding no longer hides a fault.
  Every call of the flash kernel's plain version on a rank (the forward
  and its remat recompute) gets S / M query rows at ``q_offset`` =
  rank x S / M, and asks for the lse.
* ``chunked_attention`` alone at (1, 2), f32, causal; with a window; with
  a soft cap: the output and dq, dk, dv within rtol = atol = 2e-5 (the
  reference's f32 tolerance, ``tests/test_kernels.py``) of ``jax.vjp``
  through ``repro.layers.attention.chunked_attention`` on the same numpy
  inputs, and of the port's own unsplit ``_Flash``.
* The same call under ``torch.no_grad()`` (serving): the plain version is
  handed every row at ``q_offset`` 0, and the output is bit-equal to the
  whole core on one rank.

Each rank is joined with its own timeout, then killed.
"""
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import attention as JA
from repro_torch.launch import steps
from repro_torch.launch.train import synthetic_batches
from repro_torch.layers import attention as TA
from repro_torch.models.base import get_config
from repro_torch.models.params import init_params
from repro_torch.train.optimizer import AdamWConfig, cast_params, init_state

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 240
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT")
REL_L2 = 2e-2
# (arch, leaf) -> limit: a distance the parent's whole-core program has too
KNOWN_DISTANCE = {("recurrentgemma_9b", "v/seg0/l0/rglru/w_r"): 3e-2,
                  ("recurrentgemma_9b", "v/seg1/l0/rglru/w_r"): 3e-2}
# f32: the program against train_step.  Measured: chatglm3-6b and yi-6b
# within 1e-6, recurrentgemma-9b within 7e-5 (its RG-LRU leaves' tiny
# gradients), whole core or split alike.
F32_REL_L2 = 1e-3
TOL = dict(rtol=2e-5, atol=2e-5)
ADAMW = AdamWConfig(lr=1e-3, warmup_steps=2)
B, S, SEED = 4, 32, 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(argv, world: int) -> None:
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


# The workers record each call of the flash kernel's plain version (the
# CPU's side of ``kernels.flash_attention.ops.flash_attention``).
RECORD = textwrap.dedent("""
    from repro_torch.kernels.flash_attention import ops as _fa_ops
    calls = []
    _plain = _fa_ops.chunked_attention_ref

    def _recording(q, k, v, causal, window, logit_cap, chunk, q_offset, kv_valid_len,
                   return_lse=False):
        calls.append({"rows": q.shape[1], "keys": k.shape[1], "q_offset": q_offset,
                      "lse": return_lse})
        return _plain(q, k, v, causal, window, logit_cap, chunk, q_offset, kv_valid_len,
                      return_lse=return_lse)

    _fa_ops.chunked_attention_ref = _recording
""")


# -- (a) the train programs ----------------------------------------------------

TRAIN_WORKER = RECORD + textwrap.dedent("""
    import sys, torch, torch.distributed as dist
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.models.base import ShapeCell, get_config
    from repro_torch.models.params import init_params
    from repro_torch.train.optimizer import AdamWConfig, init_state

    arch, mp, core, dtype, out = (sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4],
                                  sys.argv[5])
    if dtype == "f32":  # the masters uncast: the step computed in f32
        from repro_torch.train import optimizer
        steps.cast_params = lambda params: optimizer.cast_params(params, torch.float32)
    if core == "whole":  # the core as it runs where the KV heads divide "model"
        from repro_torch.layers import attention as A

        def whole(mesh, q, k, v, spec, q_offset):
            pq, pk = A._core_placements(mesh, q, k)
            return A.local_region(lambda ql, kl, vl: A._Flash.apply(ql, kl, vl, spec, q_offset),
                                  (q, k, v), (pq, pk, pk), pq)

        A._row_split = whole
    mesh = make_host_mesh(model_parallel=mp, device="cpu")
    cfg = get_config(arch).reduced()
    prog = steps.build_train_program(cfg, ShapeCell("t", "train", {S}, {B}), mesh,
                                     adamw=AdamWConfig(lr=1e-3, warmup_steps=2))
    state = init_state(init_params(steps.model_specs(cfg), seed={SEED}, device="cpu"))
    batch = {{k: torch.from_numpy(v) for k, v in next(synthetic_batches(cfg, {B}, {S})).items()}}
    state, metrics = prog.run(state, batch)
    full = {{f"{{p}}/{{k}}": v.full_tensor() for p in ("params", "m", "v")
            for k, v in getattr(state, p).items()}}
    full["loss"] = metrics["loss"].full_tensor()
    rank = dist.get_rank()
    torch.save({{"calls": calls, **(full if rank == 0 else {{}})}},
               f"{{out}}.{{core}}.{{dtype}}.{{rank}}")
    dist.destroy_process_group()
""").format(S=S, B=B, SEED=SEED)


def _train_step(cfg) -> dict:
    """The unsharded ``train_step``'s state and loss."""
    state = init_state(init_params(steps.model_specs(cfg), seed=SEED, device="cpu"))
    batch = {k: torch.from_numpy(v) for k, v in next(synthetic_batches(cfg, B, S)).items()}
    state, metrics = steps.train_step(cfg, state, batch, ADAMW)
    return {"loss": metrics["loss"], **{f"{p}/{k}": v for p in ("params", "m", "v")
                                        for k, v in getattr(state, p).items()}}


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("arch,mp", [("recurrentgemma_9b", 2), ("yi_6b", 4), ("chatglm3_6b", 4)],
                         ids=["recurrentgemma_9b-1x2", "yi_6b-1x4", "chatglm3_6b-1x4"])
def test_train_program_splits_the_core_rows(arch, mp, dtype, tmp_path, monkeypatch):
    cfg = get_config(arch).reduced()
    assert cfg.num_kv_heads % mp and S % mp == 0  # the row split's case
    out = tmp_path / "train.pt"
    cores = ("split", "whole") if dtype == "bf16" else ("split",)
    for core in cores:
        _launch(["-c", TRAIN_WORKER, arch, str(mp), core, dtype, str(out)], mp)
    attn_layers = sum(seg.pattern.count("attn") * seg.num_units for seg in cfg.segments)
    rows = S // mp
    for rank in range(mp):
        calls = torch.load(f"{out}.split.{dtype}.{rank}")["calls"]
        # each attention layer's forward and its remat recompute
        assert len(calls) == 2 * attn_layers, calls
        for c in calls:
            assert c == {"rows": rows, "keys": S, "q_offset": rank * rows, "lse": True}, c
        if dtype == "bf16":
            assert all(c["rows"] == S for c in torch.load(f"{out}.whole.bf16.{rank}")["calls"])

    got = torch.load(f"{out}.split.{dtype}.0")
    if dtype == "f32":  # as the workers compute it
        monkeypatch.setattr(steps, "cast_params",
                            lambda params: cast_params(params, torch.float32))
    want = _train_step(cfg)
    if dtype == "f32":
        for key, v in want.items():
            assert _rel_l2(got[key], v) < F32_REL_L2, (key, _rel_l2(got[key], v))
        return
    whole = torch.load(f"{out}.whole.bf16.0")
    for key, v in want.items():
        limit = KNOWN_DISTANCE.get((arch, key), REL_L2)
        assert _rel_l2(got[key], v) < limit, (key, _rel_l2(got[key], v), limit)
        assert _rel_l2(got[key], whole[key]) < REL_L2, key


# -- (b), (c) chunked_attention alone ------------------------------------------

# (B, S, H, Hkv, D, window, logit_cap, chunk): MQA, so "model" = 2 splits rows
CASES = {
    "causal": (2, 32, 4, 1, 16, 0, 0.0, 8),
    "window": (2, 32, 4, 1, 16, 12, 0.0, 8),
    "softcap": (2, 32, 4, 1, 16, 0, 5.0, 8),
}

CORE_WORKER = RECORD + textwrap.dedent("""
    import sys, torch, torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.layers.attention import AttnSpec, chunked_attention

    inputs, out = sys.argv[1], sys.argv[2]
    mesh = make_host_mesh(model_parallel=2, device="cpu")
    got = {}
    for name, case in torch.load(inputs).items():
        spec = AttnSpec(causal=True, window=case["window"], logit_cap=case["cap"],
                        chunk=case["chunk"])
        dt = [distribute_tensor(case[n], mesh, [Replicate(), Replicate()])
              for n in ("q", "k", "v", "do")]
        q, k, v = (t.requires_grad_() for t in dt[:3])
        del calls[:]
        o = chunked_attention(q, k, v, spec)
        (o * dt[3]).sum().backward()
        rec = {"o": o.full_tensor().detach(), "dq": q.grad.full_tensor(),
               "dk": k.grad.full_tensor(), "dv": v.grad.full_tensor(), "calls": list(calls)}
        del calls[:]
        with torch.no_grad():
            rec["o_nograd"] = chunked_attention(*(t.detach() for t in dt[:3]),
                                                spec).full_tensor()
        rec["calls_nograd"] = list(calls)
        got[name] = rec
    torch.save(got, f"{out}.{dist.get_rank()}")
    dist.destroy_process_group()
""")


def _case_inputs(case, seed=0) -> dict:
    Bc, Sc, H, Hkv, D = case[:5]
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((Bc, Sc, H, D), (Bc, Sc, Hkv, D), (Bc, Sc, Hkv, D), (Bc, Sc, H, D)))
    return {"q": q, "k": k, "v": v, "do": do}


@pytest.fixture(scope="module")
def split_core(tmp_path_factory):
    """Every case run once on two gloo ranks: (inputs, each rank's record)."""
    tmp = tmp_path_factory.mktemp("attn_split")
    inputs = {name: _case_inputs(case) for name, case in CASES.items()}
    torch.save({name: {**{n: torch.from_numpy(a) for n, a in arrs.items()},
                       "window": CASES[name][5], "cap": CASES[name][6],
                       "chunk": CASES[name][7]}
                for name, arrs in inputs.items()}, tmp / "inputs.pt")
    _launch(["-c", CORE_WORKER, str(tmp / "inputs.pt"), str(tmp / "core.pt")], 2)
    return inputs, [torch.load(tmp / f"core.pt.{r}") for r in range(2)]


@pytest.mark.parametrize("name", list(CASES))
def test_split_core_matches_jax_grad(name, split_core):
    inputs, ranks = split_core
    Bc, Sc, H, Hkv, D, window, cap, chunk = CASES[name]
    arrs = inputs[name]
    jspec = JA.AttnSpec(causal=True, window=window, logit_cap=cap, chunk=chunk)
    o, vjp = jax.vjp(lambda q, k, v: JA.chunked_attention(q, k, v, jspec),
                     *(jnp.asarray(arrs[n]) for n in ("q", "k", "v")))
    want = {"o": o, **dict(zip(("dq", "dk", "dv"), vjp(jnp.asarray(arrs["do"]))))}

    tspec = TA.AttnSpec(causal=True, window=window, logit_cap=cap, chunk=chunk)
    q, k, v = (torch.from_numpy(arrs[n]).requires_grad_() for n in ("q", "k", "v"))
    to = TA.chunked_attention(q, k, v, tspec)
    to.backward(torch.from_numpy(arrs["do"]))
    unsplit = {"o": to.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}

    rows = Sc // 2
    for rank, got in enumerate(ranks):
        rec = got[name]
        # forward and backward on this rank's rows only
        assert rec["calls"] == [{"rows": rows, "keys": Sc, "q_offset": rank * rows,
                                 "lse": True}], rec["calls"]
        for n in ("o", "dq", "dk", "dv"):
            np.testing.assert_allclose(rec[n].numpy(), np.asarray(want[n]), **TOL,
                                       err_msg=f"{name} {n} against jax.vjp")
            np.testing.assert_allclose(rec[n].numpy(), unsplit[n].numpy(), **TOL,
                                       err_msg=f"{name} {n} against the unsplit _Flash")


@pytest.mark.parametrize("name", list(CASES))
def test_no_grad_core_stays_whole_and_bit_equal(name, split_core):
    inputs, ranks = split_core
    Bc, Sc, H, Hkv, D, window, cap, chunk = CASES[name]
    spec = TA.AttnSpec(causal=True, window=window, logit_cap=cap, chunk=chunk)
    with torch.no_grad():
        want = TA.chunked_attention(*(torch.from_numpy(inputs[name][n])
                                      for n in ("q", "k", "v")), spec)
    for got in ranks:
        rec = got[name]
        assert rec["calls_nograd"] == [{"rows": Sc, "keys": Sc, "q_offset": 0, "lse": False}]
        assert torch.equal(rec["o_nograd"], want)
