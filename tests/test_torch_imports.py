"""Import guard of the PyTorch port: no file of ``src/repro_torch``, not
``chip_smoke.py``, no ``scripts/torch_*.py`` and no ``examples/torch_*.py``
imports ``jax`` or the JAX package ``repro`` (an ``ast`` scan of every import statement, relative
imports resolved)."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "scripts").glob("torch_*.py"))
         + sorted((ROOT / "examples").glob("torch_*.py")))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    # Package of the file, for resolving relative imports.
    if PORT in path.parents:
        rel = path.relative_to(PORT.parent).with_suffix("")
        package = list(rel.parts[:-1])
    else:
        package = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[: len(package) - node.level + 1]
                yield ".".join(base + ([node.module] if node.module else []))
            else:
                yield node.module


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_scan_covers_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "chip_smoke.py" in names
    assert "scripts/torch_hillclimb.py" in names
    assert "examples/torch_multi_query_serving.py" in names
    assert "src/repro_torch/kernels/segagg/ops.py" in names
    assert "src/repro_torch/serve/analytics.py" in names
    for module in ("serve/engine.py", "models/lm.py", "models/params.py",
                   "models/base.py", "models/config.py", "layers/attention.py",
                   "layers/rglru.py", "layers/common.py",
                   "kernels/flash_attention/ops.py",
                   "kernels/flash_attention/flash_attention.py",
                   "kernels/flash_attention/ref.py", "kernels/rglru/ops.py",
                   "kernels/rglru/rglru.py", "kernels/rglru/ref.py",
                   "kernels/ssd/ops.py", "kernels/ssd/ssd.py", "kernels/ssd/ref.py",
                   "layers/ssd.py", "configs/recurrentgemma_9b.py",
                   "configs/mamba2_370m.py", "core/schedulability.py",
                   "core/tenancy.py", "core/overload.py", "core/forecast.py",
                   "core/simulator.py", "core/panes.py", "core/session.py",
                   "core/_deprecation.py", "core/constraints.py",
                   "core/single_query.py", "core/multi_query.py",
                   "dist/mesh.py", "dist/roofline.py", "dist/machine.py",
                   "dist/sharding.py", "train/optimizer.py", "train/checkpoint.py",
                   "launch/steps.py", "launch/train.py"):
        assert f"src/repro_torch/{module}" in names
    assert len(FILES) >= 50


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_relative_imports_resolve_inside_the_port():
    # dynamic.py's lazy ``from ...dist.sharding import`` must reach the
    # port's own copy, not repro.dist.sharding.
    mods = list(_imported_modules(PORT / "core" / "policies" / "dynamic.py"))
    assert "repro_torch.dist.sharding" in mods
    assert all(not _forbidden(m) for m in mods)


@pytest.mark.parametrize("source, bad", [
    ("import jax.numpy as jnp", True),
    ("from repro.core import Planner", True),
    ("import repro", True),
    ("from jax import lax", True),
    ("import repro_torch.core", False),
    ("import torch", False),
])
def test_guard_catches_forbidden_imports(tmp_path, source, bad):
    path = tmp_path / "mod.py"
    path.write_text(source + "\n")
    assert any(_forbidden(m) for m in _imported_modules(path)) is bad
