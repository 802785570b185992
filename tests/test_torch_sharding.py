"""The port's partition plan against the JAX package's, on the CPU.

``param_pspecs``, ``input_pspecs``, ``cache_pspecs`` and ``batch_spec``,
with the ``sharding_fallback`` events in the order they are sent, must
equal ``repro.dist.sharding``'s exactly for all ten configs at full size
(specs only, no arrays) on abstract meshes: the JAX side on
``jax.sharding.AbstractMesh``, the port on a mapping of axis name to size.
Also: ``to_placements`` splits each dim as its spec divides it,
``constrain`` is the identity off a mesh, the meta stand-ins
(``input_specs``, ``shape_structs``, ``state_shape_structs``) have the JAX
package's shapes and dtypes, and ``active_params``/``model_flops`` are the
JAX dry run's.
"""
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.dist import sharding as JS
from repro.models import base as JB
from repro.models import lm as JL
from repro.models import params as JP
from repro.models.encdec import build_encdec_specs as j_encdec_specs
from repro.train import optimizer as JO
from repro_torch.dist import context as TC
from repro_torch.dist import sharding as TS
from repro_torch.launch import steps as TSt
from repro_torch.models import base as TB
from repro_torch.models import lm as TL
from repro_torch.models import params as TP
from repro_torch.train import optimizer as TO

MESHES = [
    {"data": 1, "model": 1},
    {"data": 2, "model": 1},
    {"data": 1, "model": 2},
    {"data": 16, "model": 16},
    {"pod": 2, "data": 16, "model": 16},
    {"data": 32, "model": 8},
    {"pod": 2, "data": 32, "model": 8},
]
MESH_IDS = ["x".join(map(str, m.values())) for m in MESHES]


def _jmesh(shape):
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def _jspecs(cfg):
    return j_encdec_specs(cfg) if cfg.family == "audio" else JL.build_specs(cfg)


def _events(on_fallback, fn):
    """``fn()``'s result and the fallback events it sent, in order."""
    got = []
    unsubscribe = on_fallback(got.append)
    try:
        return fn(), got
    finally:
        unsubscribe()


def _plan_jax(arch, mesh):
    cfg = JB.get_config(arch)

    def plan():
        out = {"params": {k: tuple(v) for k, v in
                          JS.param_pspecs(_jspecs(cfg), mesh).items()}}
        for name, cell in JB.SHAPES.items():
            structs = JB.input_specs(cfg, cell)
            out[f"inputs/{name}"] = {k: tuple(v) for k, v in
                                     JS.input_pspecs(structs, mesh).items()}
            out[f"batch/{name}"] = JS.batch_spec(mesh, cell.global_batch, 3)
            if cell.kind == "decode":
                cache = JL.cache_shape_specs(cfg, cell.global_batch, cell.seq_len)
                out[f"cache/{name}"] = {k: tuple(v) for k, v in
                                        JS.cache_pspecs(cfg, cache, mesh).items()}
        return out

    return _events(JS.on_fallback, plan)


def _plan_port(arch, mesh):
    cfg = TB.get_config(arch)

    def plan():
        out = {"params": TS.param_pspecs(TSt.model_specs(cfg), mesh)}
        for name, cell in TB.SHAPES.items():
            structs = TB.input_specs(cfg, cell)
            out[f"inputs/{name}"] = TS.input_pspecs(structs, mesh)
            out[f"batch/{name}"] = TS.batch_spec(mesh, cell.global_batch, 3)
            if cell.kind == "decode":
                cache = TL.cache_shape_specs(cfg, cell.global_batch, cell.seq_len)
                out[f"cache/{name}"] = TS.cache_pspecs(cfg, cache, mesh)
        return out

    return _events(TS.on_fallback, plan)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", TB.ARCH_IDS)
def test_partition_plan_matches_reference(arch, mesh):
    want, want_events = _plan_jax(arch, _jmesh(mesh))
    got, got_events = _plan_port(arch, mesh)
    assert got.keys() == want.keys()
    for part in want:
        assert got[part] == want[part], part
    assert got_events == want_events


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_to_placements_divides_as_the_spec(mesh):
    specs = TSt.model_specs(TB.get_config("mixtral_8x22b"))
    sizes = dict(mesh)
    for name, spec in TS.param_pspecs(specs, mesh).items():
        shape = list(specs[name].shape)
        want = list(shape)
        for d, entry in enumerate(spec):
            for ax in (entry,) if isinstance(entry, str) else (entry or ()):
                want[d] //= sizes[ax]
        local = list(shape)
        for size, p in zip(sizes.values(), TC.to_placements(spec, mesh)):
            if p.is_shard():
                local[p.dim] //= size
        assert local == want, name


def test_to_placements_pod_major():
    from torch.distributed.tensor import Replicate, Shard

    mesh = {"pod": 2, "data": 32, "model": 8}
    assert TC.to_placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert TC.to_placements(None, mesh) == (Replicate(),) * 3


def test_constrain_is_identity_off_a_mesh():
    x = torch.randn(4, 8, 16)
    assert TC.constrain(x, "batch", "seq_model", None) is x
    assert TC.constrain_param(x, ("layers", "embed", "heads")) is x
    with TC.mesh_context({"data": 2, "model": 2}):
        # a plain tensor inside a mesh context is left as it is too
        assert TC.constrain(x, "batch", None, "model") is x


def _sig(t):
    """(shape, dtype name) of a JAX struct or a torch tensor."""
    dt = str(t.dtype).replace("torch.", "")
    return tuple(t.shape), dt


@pytest.mark.parametrize("shape", list(TB.SHAPES))
@pytest.mark.parametrize("arch", TB.ARCH_IDS)
def test_meta_structs_match_reference(arch, shape):
    jcfg, tcfg = JB.get_config(arch), TB.get_config(arch)
    want = JB.input_specs(jcfg, JB.SHAPES[shape])
    got = TB.input_specs(tcfg, TB.SHAPES[shape])
    assert all(t.device.type == "meta" for t in got.values())
    assert {k: _sig(v) for k, v in got.items()} == {k: _sig(v) for k, v in want.items()}
    if shape != "train_4k":
        return
    jp = JP.shape_structs(_jspecs(jcfg))
    tp = TP.shape_structs(TSt.model_specs(tcfg))
    assert {k: _sig(v) for k, v in tp.items()} == {k: _sig(v) for k, v in jp.items()}
    js, ts = JO.state_shape_structs(jp), TO.state_shape_structs(tp)
    for part in ("params", "m", "v"):
        assert {k: _sig(v) for k, v in getattr(ts, part).items()} == \
            {k: _sig(v) for k, v in getattr(js, part).items()}
    assert all(t.device.type == "meta" for t in ts.params.values())


@pytest.fixture(scope="module")
def jax_dryrun():
    """``repro.launch.dryrun``, imported after the JAX backend is up (its
    import sets XLA_FLAGS); the environment is restored afterwards."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun

    yield dryrun
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved


@pytest.mark.parametrize("arch", TB.ARCH_IDS)
def test_active_params_and_model_flops_match_reference(arch, jax_dryrun):
    from repro_torch.launch import dryrun as TD

    jcfg, tcfg = JB.get_config(arch), TB.get_config(arch)
    assert TD.active_params(tcfg) == jax_dryrun.active_params(jcfg)
    for name in TB.SHAPES:
        assert TD.model_flops(tcfg, TB.SHAPES[name]) == \
            jax_dryrun.model_flops(jcfg, JB.SHAPES[name])
    assert np.isfinite(TD.model_flops(tcfg, TB.SHAPES["train_4k"]))
