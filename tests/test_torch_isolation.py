"""The port stands alone: it imports neither JAX/flax nor the JAX package,
its weight import covers the production variable tree exactly, and its
entry point runs on CUDA unless the caller asks for the CPU.
"""
import ast
import inspect
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from creste_public_tpu.config import presets as jpresets
from creste_public_tpu.models.lfd import MaxEntIRL as JMaxEntIRL
from creste_public_tpu_torch.config import presets
from creste_public_tpu_torch.models.lfd import MaxEntIRL
from creste_public_tpu_torch.runtime import export
from creste_public_tpu_torch.weights import from_jax_variables

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "creste_public_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "creste_public_tpu", "yaml")


def test_import_pulls_in_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import creste_public_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len(list(pkgutil.walk_packages(p.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", sorted(
    [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]), ids=lambda p: p.name)
def test_source_imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path}: imports {n}"


def _production_tree() -> dict:
    """The production MaxEntIRL variable tree (shapes only). Parameter
    shapes do not depend on the image size, so the abstract init traces a
    64x80 frame."""
    cfg = jpresets.traversability_model_config(image_size=(64, 80)).to_dict()
    cfg["solve_mdp"] = False
    rgbd = np.zeros((1, 1, 64, 80, 4), np.float32)
    p2p = np.tile(np.eye(4, dtype=np.float32), (1, 1, 1, 1))
    tree = jax.eval_shape(lambda: JMaxEntIRL(cfg).init(
        {"params": jax.random.PRNGKey(0)}, rgbd, p2p))
    return {k: np.zeros(v.shape, np.float32)
            for k, v in flatten_dict(dict(tree), sep="/").items()}


def test_weight_import_covers_production_tree():
    flat = _production_tree()
    cfg = presets.traversability_model_config().to_dict()
    cfg["solve_mdp"] = False
    model = MaxEntIRL(cfg)
    sd = from_jax_variables(flat)
    assert len(sd) == len(flat)
    model.load_state_dict(sd, strict=True)
    # every parameter and buffer that a state_dict carries came from a leaf
    assert set(model.state_dict()) == set(sd)

    extra = dict(flat)
    extra["params/backbone/extra_conv/kernel"] = np.zeros((1, 1, 2, 2))
    with pytest.raises(RuntimeError, match="Unexpected"):
        model.load_state_dict(from_jax_variables(extra), strict=True)
    missing = dict(flat)
    missing.pop("batch_stats/traversability_head/r/trunk_bn_0/var")
    with pytest.raises(RuntimeError, match="Missing"):
        model.load_state_dict(from_jax_variables(missing), strict=True)
    with pytest.raises(ValueError, match="no rule"):
        from_jax_variables({"params/x/embedding": np.zeros(3)})


def test_entry_point_defaults_to_cuda(monkeypatch):
    sig = inspect.signature(export.build_inference_fn)
    assert sig.parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = presets.tiny_traversability_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        export.build_inference_fn(cfg, {})
