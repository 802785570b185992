"""The port's training path on the CPU against the JAX package's: the loss
functions' values and every gradient leaf (``lm_loss`` for the reduced
dense, GQA, partial-RoPE, LayerNorm-with-bias, vision-patch, MoE, SSM
(mamba2-370m, through ``_SSD`` and ``ssd_bwd``) and hybrid RG-LRU
(recurrentgemma-9b, through ``_RGLRU`` and ``rglru_bwd_ref``) configs,
``encdec_loss`` for reduced whisper-medium) against
``jax.value_and_grad``; remat on and off; ``xent_loss`` over several
blocks with masked labels; two AdamW updates (one clipped) against
``repro.train.optimizer.apply_updates``; ``synthetic_batches``; the
checkpoint format both ways; and the trainer on the CPU (``main``) lowering its
loss, checkpointing and resuming (yi-6b), and training mamba2-370m.  Parameters are the JAX package's seeded
init in f32, carried across with ``params_from_numpy``; batches are numpy.

Tolerances: f32 throughout.  The loss within 1e-5 relative and each
gradient leaf within 1e-4 relative L2 (summation order only).  A leaf whose
reference gradient is below ``ZERO_LEAF`` of the whole gradient's norm is
held to 1e-4 of that floor instead: whisper's ``bk`` leaves have gradient 0
in exact arithmetic (adding one vector to every key adds one constant to a
row's scores, which a softmax ignores), so both packages give rounding
noise there (~5e-8 against a norm of ~5).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import train as JT
from repro.models import base as JB
from repro.models import encdec as JE
from repro.models import lm as JL
from repro.models import params as JP
from repro.train import checkpoint as JC
from repro.train import optimizer as JO
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TT
from repro_torch.models import base as TB
from repro_torch.models import encdec as TE
from repro_torch.models import lm as TL
from repro_torch.models import params as TP
from repro_torch.train import checkpoint as TC
from repro_torch.train import optimizer as TO

LOSS_TOL = 1e-5
LEAF_TOL = 1e-4
ZERO_LEAF = 1e-3
ARCHS = ("yi_6b", "granite_8b", "chatglm3_6b", "starcoder2_7b", "internvl2_76b",
         "olmoe_1b_7b", "whisper_medium", "mamba2_370m", "recurrentgemma_9b")


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _both(arch, seed=1, **overrides):
    """The reduced config in both packages and its f32 parameters: the JAX
    package's seeded init, carried across one key to one key."""
    jcfg = dataclasses.replace(JB.get_config(arch).reduced(), **overrides)
    tcfg = dataclasses.replace(TB.get_config(arch).reduced(), **overrides)
    specs = (JE.build_encdec_specs(jcfg) if jcfg.family == "audio"
             else JL.build_specs(jcfg))
    jp = {k: v.astype(jnp.float32)
          for k, v in JP.init_params(specs, jax.random.PRNGKey(seed)).items()}
    tp = TP.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    return jcfg, tcfg, jp, tp


def _batch(cfg, B=2, S=128, seed=3):
    """Tokens and next-token labels, some masked (-1), plus patches or
    frames where the config's frontend takes them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :5] = -1
    batch["labels"][-1, -3:] = -1
    if cfg.frontend == "vision":
        batch["patches"] = rng.normal(0, 0.02, (B, cfg.num_patches, cfg.d_model)
                                      ).astype(np.float32)
    if cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)
                                              ).astype(np.float32)
    return batch


def _reference(jcfg, jp, batch):
    loss_fn = JE.encdec_loss if jcfg.family == "audio" else JL.lm_loss
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: loss_fn(jcfg, p, jb), has_aux=True)(jp)
    return float(loss), metrics, grads


def _port(tcfg, tp, batch, remat=True):
    loss_fn = TE.encdec_loss if tcfg.family == "audio" else TL.lm_loss
    params = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss, metrics = loss_fn(tcfg, params, {k: torch.from_numpy(v) for k, v in batch.items()},
                            remat=remat)
    loss.backward()
    return loss, metrics, {k: v.grad for k, v in params.items()}


def _check_grads(got, want):
    assert set(got) == set(want)
    whole = np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2) for g in want.values()))
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        err = np.linalg.norm(got[k].numpy() - w)
        scale = max(np.linalg.norm(w), ZERO_LEAF * whole)
        assert err <= LEAF_TOL * scale, (k, err / scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    jcfg, tcfg, jp, tp = _both(arch)
    batch = _batch(jcfg)
    jloss, jmetrics, jgrads = _reference(jcfg, jp, batch)
    loss, metrics, grads = _port(tcfg, tp, batch)
    assert abs(loss.item() - jloss) <= LOSS_TOL * abs(jloss)
    assert float(metrics["tokens"]) == float(jmetrics["tokens"]) == batch["labels"].size - 8
    if "aux" in jmetrics:
        assert abs(metrics["aux"].item() - float(jmetrics["aux"])) <= 1e-5
    if tcfg.num_experts:
        assert metrics["aux"].item() > 0
    _check_grads(grads, jgrads)


@pytest.mark.parametrize("arch", ["yi_6b", "whisper_medium", "mamba2_370m",
                                  "recurrentgemma_9b"])
def test_remat_changes_no_gradient(arch):
    _, tcfg, _, tp = _both(arch)
    batch = _batch(tcfg, S=64)
    loss_r, _, grads_r = _port(tcfg, tp, batch, remat=True)
    loss_n, _, grads_n = _port(tcfg, tp, batch, remat=False)
    assert torch.equal(loss_r, loss_n)
    for k in grads_n:
        torch.testing.assert_close(grads_r[k], grads_n[k], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("S, block", [(32, 8), (30, 8), (24, 1024)])
def test_xent_loss_in_blocks(S, block):
    """Several blocks (4 of 8; 3 of 10 when 30 // 8 does not divide), or
    one, with masked labels: the value and the gradients of the hidden
    states and of the unembedding's parameters."""
    jcfg, tcfg, jp, tp = _both("yi_6b")
    rng = np.random.default_rng(S)
    hidden = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    labels[0, ::3] = -1
    keys = ("final_norm", "unembed")

    def jloss(h, p):
        return JL.xent_loss(jcfg, {**jp, **p}, h, jnp.asarray(labels), block=block)

    (jl, jm), (jgh, jgp) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hidden), {k: jp[k] for k in keys})
    h = torch.from_numpy(hidden).requires_grad_(True)
    p = {k: tp[k].clone().requires_grad_(True) for k in keys}
    loss, metrics = TL.xent_loss(tcfg, {**tp, **p}, h, torch.from_numpy(labels), block=block)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= LOSS_TOL * abs(float(jl))
    assert float(metrics["tokens"]) == float(jm["tokens"]) == (labels >= 0).sum()
    assert torch.equal(metrics["xent"], loss)
    assert _rel(h.grad, jgh) <= LEAF_TOL
    for k in keys:
        assert _rel(p[k].grad, jgp[k]) <= LEAF_TOL


def _opt_inputs(seed):
    rng = np.random.default_rng(seed)
    shapes = {"embed/tokens": (16, 8), "seg0/l0/attn/norm": (2, 8), "final_norm": (8,),
              "seg0/l0/attn/wq": (2, 8, 2, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) * scale for k, s in shapes.items()}
             for scale in (0.02, 3.0)]       # the second step's norm is clipped
    return params, grads


def test_apply_updates_matches_reference():
    params, grads = _opt_inputs(5)
    cfg_j = JO.AdamWConfig(lr=1e-2, warmup_steps=3)
    cfg_t = TO.AdamWConfig(lr=1e-2, warmup_steps=3)
    js = JO.init_state({k: jnp.asarray(v) for k, v in params.items()})
    ts = TO.init_state({k: torch.from_numpy(v) for k, v in params.items()})
    first = ts.params
    for step, g in enumerate(grads, start=1):
        js, jm = JO.apply_updates(js, {k: jnp.asarray(v) for k, v in g.items()}, cfg_j)
        ts, tm = TO.apply_updates(ts, {k: torch.from_numpy(v) for k, v in g.items()}, cfg_t)
        assert ts.step == int(js.step) == step
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
        for part in ("params", "m", "v"):
            for k, want in getattr(js, part).items():
                np.testing.assert_allclose(getattr(ts, part)[k].numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-9, err_msg=f"{part} {k}")
    assert float(tm["grad_norm"]) > cfg_t.clip_norm
    # weight decay reaches the (units, D) norm gain, as in the reference
    assert not np.allclose(ts.params["seg0/l0/attn/norm"].numpy(), params["seg0/l0/attn/norm"])
    # the state is updated in place (the reference donates it)
    assert ts.params["final_norm"] is first["final_norm"]


@pytest.mark.parametrize("arch", ["yi_6b", "internvl2_76b", "whisper_medium"])
def test_synthetic_batches_equal_reference(arch):
    cfg = JB.get_config(arch).reduced()
    want = JT.synthetic_batches(cfg, 3, 16, seed=4)
    got = TT.synthetic_batches(TB.get_config(arch).reduced(), 3, 16, seed=4)
    for _ in range(3):
        w, g = next(want), next(got)
        assert sorted(w) == sorted(g)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"params/seg0/l0/attn/wq": rng.standard_normal((2, 3, 4)).astype(np.float32),
            "m/final_norm": rng.standard_normal(5).astype(np.float32),
            "v/embed/tokens": rng.standard_normal((7, 3)).astype(np.float32)}


def test_checkpoints_cross_packages(tmp_path):
    tree = _tree(0)
    # the port writes, the reference validates and restores
    path = TC.save_checkpoint(tmp_path / "t", 3, {k: torch.from_numpy(v) for k, v in tree.items()},
                              extra={"loss": 1.5})
    assert path.name == "step_00000003"
    assert JC.latest_valid(tmp_path / "t") == path
    step, restored, extra = JC.restore_checkpoint(path)
    assert step == 3 and extra == {"loss": 1.5}
    for k, v in tree.items():
        np.testing.assert_array_equal(np.asarray(restored[k]), v)
    # the reference writes, the port validates and restores
    path = JC.save_checkpoint(tmp_path / "j", 12, {k: jnp.asarray(v) for k, v in tree.items()})
    assert TC.latest_valid(tmp_path / "j") == path
    step, restored, extra = TC.restore_checkpoint(path, device="cpu")
    assert step == 12 and extra == {}
    for k, v in tree.items():
        assert restored[k].device.type == "cpu"
        np.testing.assert_array_equal(restored[k].numpy(), v)
    assert json.loads((path / "manifest.json").read_text())["leaves"].keys() == tree.keys()


@pytest.mark.parametrize("damage", ["checksum", "truncated", "missing_manifest"])
def test_latest_valid_skips_a_corrupted_newer_step(tmp_path, damage):
    good = TC.save_checkpoint(tmp_path, 4, {k: torch.from_numpy(v)
                                            for k, v in _tree(1).items()})
    bad = TC.save_checkpoint(tmp_path, 8, {k: torch.from_numpy(v)
                                           for k, v in _tree(2).items()})
    leaf = bad / "params__seg0__l0__attn__wq.npy"
    if damage == "checksum":
        arr = np.load(leaf)
        arr[0, 0, 0] += 1.0
        np.save(leaf, arr)
    elif damage == "truncated":
        leaf.write_bytes(leaf.read_bytes()[:40])
    else:
        (bad / "manifest.json").unlink()
    assert TC.latest_valid(tmp_path) == good
    assert JC.latest_valid(tmp_path) == good


def test_train_step_microbatches_average_the_gradients():
    """internvl2's two microbatches: the loss is their mean and the
    gradient their f32 mean, so one step on four rows equals the update
    that ``apply_updates`` makes from the mean of the two halves'
    gradients (each half's loss function differentiated alone)."""
    _, tcfg, _, tp = _both("internvl2_76b")
    assert tcfg.train_microbatches == 2
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg, B=4, S=32).items()}
    state = TO.init_state(tp)
    adamw = TO.AdamWConfig(lr=1e-2, warmup_steps=1)
    new, metrics = TS.train_step(tcfg, TO.init_state(tp), batch, adamw)
    halves, losses = [], []
    for rows in (slice(0, 2), slice(2, 4)):
        p = {k: v.clone().requires_grad_(True) for k, v in state.params.items()}
        loss, _ = TL.lm_loss(tcfg, TO.cast_params(p), {k: v[rows] for k, v in batch.items()})
        loss.backward()
        halves.append({k: v.grad for k, v in p.items()})
        losses.append(loss.detach())
    want, _ = TO.apply_updates(state, {k: (halves[0][k] + halves[1][k]) / 2
                                       for k in halves[0]}, adamw)
    torch.testing.assert_close(metrics["loss"], (losses[0] + losses[1]) / 2)
    assert new.step == want.step == 1
    for k in want.params:
        torch.testing.assert_close(new.params[k], want.params[k])
        torch.testing.assert_close(new.v[k], want.v[k])


def test_cpu_trainer_trains_checkpoints_and_resumes(tmp_path):
    argv = ["--device", "cpu", "--arch", "yi_6b", "--steps", "8", "--batch", "4",
            "--seq", "32", "--lr", "5e-3", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "4"]
    first = TT.main(argv)
    assert first["start_step"] == 0 and len(first["losses"]) == 8
    assert all(np.isfinite(first["losses"]))
    assert first["losses"][-1] < first["losses"][0]
    assert [p.name for p in first["checkpoints"]] == ["step_00000004", "step_00000008"]
    assert TC.latest_valid(tmp_path).name == "step_00000008"
    again = TT.main(argv[:5] + ["10"] + argv[6:] + ["--resume"])
    assert again["start_step"] == 8 and len(again["losses"]) == 2
    assert all(np.isfinite(again["losses"]))
    assert TC.latest_valid(tmp_path).name == "step_00000010"


def test_cpu_trainer_trains_mamba2(tmp_path):
    """``--arch mamba2_370m`` (reduced and widened: 4 ``ssm`` layers) through
    ``_SSD`` and ``ssd_bwd``: the loss falls, checkpoints are written."""
    argv = ["--device", "cpu", "--arch", "mamba2_370m", "--steps", "6", "--batch", "4",
            "--seq", "48", "--lr", "5e-3", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    out = TT.main(argv)
    assert out["start_step"] == 0 and len(out["losses"]) == 6
    assert all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]
    assert [p.name for p in out["checkpoints"]] == ["step_00000003", "step_00000006"]
