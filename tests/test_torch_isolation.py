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
from flax.traverse_util import flatten_dict, unflatten_dict

from creste_public_tpu.config import presets as jpresets
from creste_public_tpu.models.lfd import MaxEntIRL as JMaxEntIRL
from creste_public_tpu.models.terrainnet import TerrainNet as JTerrainNet
from creste_public_tpu_torch import weights
from creste_public_tpu_torch.config import presets
from creste_public_tpu_torch.models.lfd import MaxEntIRL
from creste_public_tpu_torch.models.terrainnet import TerrainNet
from creste_public_tpu_torch.runtime import export
from creste_public_tpu_torch.weights import from_jax_variables

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "creste_public_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "creste_public_tpu", "yaml",
             "matplotlib", "sklearn")


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


# the modules the stage-2 branches added (the checks above walk the whole
# package; these must stay among what they walk)
BRANCH_MODULES = ("ops/warp.py", "models/blocks/convgru.py",
                  "losses/balancedsupcon.py")


@pytest.mark.parametrize("rel_path", BRANCH_MODULES)
def test_branch_modules_are_checked(rel_path):
    path = PKG / rel_path
    assert path in set(PKG.rglob("*.py"))
    test_source_imports(path)


# the runtime slice's modules: the same checks, and each imports without
# starting anything (the entry points run only under __main__)
RUNTIME_MODULES = ("runtime/precision.py", "runtime/export.py",
                   "runtime/benchmark.py", "runtime/compile.py",
                   "runtime/serve.py", "runtime/parity_check.py",
                   "training/torch_import.py")


@pytest.mark.parametrize("rel_path", RUNTIME_MODULES)
def test_runtime_modules_are_checked(rel_path):
    path = PKG / rel_path
    assert path in set(PKG.rglob("*.py"))
    test_source_imports(path)


# the data-parallel slice's modules
PARALLEL_MODULES = ("parallel/__init__.py", "parallel/mesh.py",
                    "parallel/launch.py", "data/augment.py",
                    "utils/image_stack.py")


@pytest.mark.parametrize("rel_path", PARALLEL_MODULES)
def test_parallel_modules_are_checked(rel_path):
    path = PKG / rel_path
    assert path in set(PKG.rglob("*.py"))
    test_source_imports(path)


# the CODa reader's (with its frame decode on the card), the validation
# images' and the secondary models' modules
CODA_MODULES = ("data/coda_constants.py", "data/taxonomy.py", "data/calib.py",
                "data/native_io.py", "data/coda_dataset.py",
                "ops/frame_kernel.py",
                "utils/colormaps.py", "utils/visualization.py",
                "training/visual_log.py", "models/stereodepth.py",
                "models/foundation.py", "models/blocks/vit.py",
                "models/blocks/cnnmlp.py")


@pytest.mark.parametrize("rel_path", CODA_MODULES)
def test_coda_modules_are_checked(rel_path):
    path = PKG / rel_path
    assert path in set(PKG.rglob("*.py"))
    test_source_imports(path)


# the preprocessing slice's modules and entry points
PREPROCESSING_CLIS = {
    "build_dense_depth": ["--root", "ROOT", "--seqs", "0"],
    "downsample_frames": ["--in_dir", "ROOT", "--out_dir", "ROOT/ds"],
    "create_sam_dataset": ["--root", "ROOT", "--seqs", "0"],
    "create_pe_dataset": ["--root", "ROOT", "--seqs", "0", "--extractor",
                          "random"],
    "build_sam_map": ["--root", "ROOT", "--seqs", "0"],
    "build_feature_map": ["--root", "ROOT", "--seqs", "0"],
    "create_traversability_dataset": ["--root", "ROOT", "--seqs", "0"],
    "build_splits": ["--root", "ROOT", "--seqs", "0"],
}
PREPROCESSING_MODULES = (
    "utils/concurrency.py", "utils/hf_weights.py",
    "ops/depth_projection.py", "ops/infill.py",
    "ops/elevation.py", "data/raw_synthetic.py", "preprocessing/__init__.py",
    "preprocessing/depth.py", "preprocessing/splits.py",
    "preprocessing/semantic_map.py", "preprocessing/sam_map.py",
    "preprocessing/features.py", "preprocessing/video_tracking.py",
    *(f"preprocessing/{name}.py" for name in PREPROCESSING_CLIS))


@pytest.mark.parametrize("rel_path", PREPROCESSING_MODULES)
def test_preprocessing_modules_are_checked(rel_path):
    path = PKG / rel_path
    assert path in set(PKG.rglob("*.py"))
    test_source_imports(path)


@pytest.mark.parametrize("name", list(PREPROCESSING_CLIS))
def test_preprocessing_cli_needs_cuda_or_cpu(name, tmp_path, monkeypatch):
    """Each preprocessing entry point refuses to start without CUDA unless
    ``--device cpu`` is given; with it, the same arguments get past the
    check (over an empty root they may then fail on a missing file)."""
    import importlib

    from creste_public_tpu_torch.preprocessing import video_tracking

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for loader in ("try_load_detector", "try_load_mask_predictor",
                   "try_load_auto_mask_generator"):
        monkeypatch.setattr(video_tracking, loader, lambda *a, **k: None)
    main = importlib.import_module(
        f"creste_public_tpu_torch.preprocessing.{name}").main
    args = [a.replace("ROOT", str(tmp_path)) for a in PREPROCESSING_CLIS[name]]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(args)
    try:
        main([*args, "--device", "cpu"])
    except (OSError, ValueError):
        pass


# the raw -> served slice's modules: annotation, the scan viewer, the
# release packager and the end-to-end script
E2E_MODULES = ("annotation/__init__.py", "annotation/control.py",
               "annotation/app.py", "utils/pointcloud_vis.py",
               "visualize_scans.py", "release/__init__.py",
               "release/package_data.py", "e2e_pipeline.py")


@pytest.mark.parametrize("rel_path", E2E_MODULES)
def test_e2e_modules_are_checked(rel_path):
    path = PKG / rel_path
    assert path in set(PKG.rglob("*.py"))
    test_source_imports(path)


def test_pointcloud_vis_imports_no_matplotlib():
    """The scan figures draw with PIL and torch: importing the module (and
    the viewer's entry point) loads no matplotlib."""
    code = ("import sys\n"
            "import creste_public_tpu_torch.utils.pointcloud_vis\n"
            "import creste_public_tpu_torch.visualize_scans\n"
            "sys.exit('matplotlib' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


# the slice's entry points that take --device, with arguments that get
# them past argparse
E2E_CLIS = {
    "e2e_pipeline": ["--work", "ROOT/work"],
    "visualize_scans": ["--root", "ROOT", "--out", "ROOT/v.html"],
}


@pytest.mark.parametrize("name", list(E2E_CLIS))
def test_e2e_cli_needs_cuda_or_cpu(name, tmp_path, monkeypatch):
    """The end-to-end script and the scan viewer refuse to start without
    CUDA unless ``--device cpu`` is given; with it they get past the check
    (the script's chain is replaced by a recorder; the viewer then fails
    on the empty root's missing scans)."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"creste_public_tpu_torch.{name}")
    ran = []
    if name == "e2e_pipeline":
        monkeypatch.setattr(module, "run_pipeline",
                            lambda work, **kw: ran.append(kw) or {})
    args = [a.replace("ROOT", str(tmp_path)) for a in E2E_CLIS[name]]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(args)
    assert not ran
    try:
        module.main([*args, "--device", "cpu"])
    except OSError:
        pass
    if name == "e2e_pipeline":
        assert [kw["device"] for kw in ran] == ["cpu"]


def _production_tree(**overrides) -> dict:
    """The production MaxEntIRL variable tree (shapes only). Parameter
    shapes do not depend on the image size, so the abstract init traces a
    64x80 frame; with ``solve_mdp`` it also traces the MDP solve."""
    cfg = jpresets.traversability_model_config(image_size=(64, 80)).to_dict()
    cfg["solve_mdp"] = False
    cfg.update(overrides)
    rgbd = np.zeros((1, 1, 64, 80, 4), np.float32)
    p2p = np.tile(np.eye(4, dtype=np.float32), (1, 1, 1, 1))
    expert = np.tile(np.eye(3, dtype=np.float32), (1, 50, 1, 1))
    args = (rgbd, p2p, expert) if cfg["solve_mdp"] else (rgbd, p2p)
    tree = jax.eval_shape(lambda: JMaxEntIRL(cfg).init(
        {"params": jax.random.PRNGKey(0)}, *args))
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


def test_reference_import_covers_production_tree():
    """The reference-style state_dict of the production tree (the JAX
    package's ``export_torch_style``) imports into the port with no key
    unmatched and loads strictly: the importer's rules cover every tensor
    of the deployment graph."""
    from creste_public_tpu.training.torch_import import export_torch_style
    from creste_public_tpu_torch.training.torch_import import (
        import_reference_state_dict,
    )

    flat = _production_tree()
    ref = export_torch_style(unflatten_dict(flat, sep="/"))
    state, unmatched = import_reference_state_dict(ref)
    assert unmatched == []
    cfg = presets.traversability_model_config().to_dict()
    cfg["solve_mdp"] = False
    MaxEntIRL(cfg).load_state_dict(state, strict=True)


def test_weight_import_covers_terrainnet_tree():
    """A flax TerrainNet tree (top-level scopes depthcomp, cam2map and
    bevclassifier) at the production stage-2 preset loads strictly."""
    cfg = jpresets.terrainnet_model_config(image_size=(64, 80)).to_dict()
    rgbd = np.zeros((1, 1, 64, 80, 4), np.float32)
    p2p = np.tile(np.eye(4, dtype=np.float32), (1, 1, 1, 1))
    tree = jax.eval_shape(lambda: JTerrainNet(cfg).init(
        {"params": jax.random.PRNGKey(0)}, rgbd, p2p))
    flat = {k: np.zeros(v.shape, np.float32)
            for k, v in flatten_dict(dict(tree), sep="/").items()}
    assert {k.split("/")[1] for k in flat} == {"depthcomp", "cam2map",
                                               "bevclassifier"}
    model = TerrainNet(presets.terrainnet_model_config().to_dict())
    sd = from_jax_variables(flat)
    model.load_state_dict(sd, strict=True)
    assert set(model.state_dict()) == set(sd)


def test_weight_import_covers_fc_policy_tree():
    """With solve_mdp and the fc rollout, the tree gains params/fc/kernel
    (2-D, (in, out)), which lands transposed on fc.weight."""
    flat = _production_tree(solve_mdp=True, policy_method="fc")
    assert flat["params/fc/kernel"].shape == (8, 8)
    flat["params/fc/kernel"] = np.arange(64, dtype=np.float32).reshape(8, 8)
    cfg = presets.traversability_model_config().to_dict()
    cfg["policy_method"] = "fc"
    model = MaxEntIRL(cfg)
    sd = from_jax_variables(flat)
    model.load_state_dict(sd, strict=True)
    assert set(model.state_dict()) == set(sd)
    np.testing.assert_array_equal(model.fc.weight.detach().numpy(),
                                  flat["params/fc/kernel"].T)
    # the seeded init covers fc like any dense layer
    init = weights.init_weights(MaxEntIRL(cfg), 0)
    assert float(init.fc.weight.detach().std()) > 0


def test_entry_point_defaults_to_cuda(monkeypatch):
    sig = inspect.signature(export.build_inference_fn)
    assert sig.parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = presets.tiny_traversability_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        export.build_inference_fn(cfg, {})


@pytest.mark.parametrize("stage, make_cfg", [
    ("depth", lambda: jpresets.tiny_depth_config().to_dict() | {
        "vision_backbone": jpresets.distillation_model_config(
            image_size=(64, 80))["vision_backbone"].to_dict(),
        "depth_head": jpresets.distillation_model_config()[
            "depth_head"].to_dict(),
        "discretize": jpresets.discretize_cfg()}),
    ("distillation", lambda: jpresets.distillation_model_config(
        image_size=(64, 80)).to_dict()),
    ("distillation", lambda: jpresets.distillation_pefree_config(
        image_size=(64, 80)).to_dict()),
    ("distillation", lambda: jpresets.distillation_pefree_config(
        image_size=(64, 80)).to_dict() | {
            "pe_map": {"height": 8, "width": 10, "use_norm": True}}),
], ids=["depth", "distillation", "pefree", "pefree_bn"])
def test_weight_import_covers_stage01_trees(stage, make_cfg):
    """The flax trees of the stage-0 and stage-1 models at the published
    widths (the PE-free one with its ``learnable_pe_map``, ``pe_head_conv``,
    ``pe_head_bn`` and multiview ``cam2map``) load strictly, every state
    key from a leaf; the seeded init gives the PE map its 0.05 N."""
    from creste_public_tpu.training import pipelines as jpipelines
    from creste_public_tpu_torch.training import pipelines

    cfg = make_cfg()
    views = int(cfg.get("views", 1))
    rgbd = np.zeros((1, views, 64, 80, 4), np.float32)
    p2p = np.tile(np.eye(4, dtype=np.float32), (1, views, 1, 1))
    jm = jpipelines.build_model(stage, cfg)
    tree = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, rgbd, p2p))
    flat = {k: np.zeros(v.shape, np.float32)
            for k, v in flatten_dict(dict(tree), sep="/").items()}
    model = pipelines.build_model(stage, cfg)
    sd = from_jax_variables(flat)
    model.load_state_dict(sd, strict=True)
    assert set(model.state_dict()) == set(sd)
    pe = getattr(weights.init_weights(model, 0), "learnable_pe_map", None)
    assert (pe is not None) == ("pe_map" in cfg)
    if pe is not None:
        assert 0.03 < float(pe.detach().std()) < 0.07


@pytest.mark.parametrize("entry", ["train_depth", "train_pefree"])
def test_stage01_entry_points_default_to_cuda(entry):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    main = importlib.import_module(f"creste_public_tpu_torch.{entry}").main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["trainer=smoke", "dataset=synthetic_tiny",
              "model=distillation/tiny"])


def test_weight_import_covers_terrainnet_branch_trees():
    """The flax TerrainNet trees of the branches at the published stage-2
    widths load strictly, every state key from a leaf: the temporal layer
    (pre-RNN conv and BatchNorm, a pose-warped GRU with its z-MLP), the
    merged decoder heads (``mh_*``, grouped convs) and ``log_var``."""
    cfg = jpresets.terrainnet_model_config(image_size=(64, 80)).to_dict()
    cfg["use_temporal"] = True
    cfg["temporal_layer"] = {"net_kwargs": {
        "rnn_input_channels": 96, "rnn_config": {
            "hidden_dims": [96], "groups": 2, "kernel_size": [3, 3],
            "use_pose": True, "use_z": True}}}
    kw = cfg["bev_classifier"]["net_kwargs"]
    kw.update(merged_heads=True, learnable_loss_weight=True,
              input_key="merged_bev_features")
    rgbd = np.zeros((1, 2, 64, 80, 4), np.float32)
    p2p = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    tree = jax.eval_shape(lambda: JTerrainNet(cfg).init(
        {"params": jax.random.PRNGKey(0)}, rgbd, p2p, None, train=False,
        pose=p2p))
    flat = {k: np.zeros(v.shape, np.float32)
            for k, v in flatten_dict(dict(tree), sep="/").items()}
    assert "params/temporal_layer/rnn/z_map_0/kernel" in flat
    assert "params/bevclassifier/mh_conv1/kernel" in flat
    assert "params/bevclassifier/log_var" in flat
    cfg_t = presets.terrainnet_model_config().to_dict()
    cfg_t.update(use_temporal=True, temporal_layer=cfg["temporal_layer"])
    cfg_t["bev_classifier"]["net_kwargs"].update(
        merged_heads=True, learnable_loss_weight=True,
        input_key="merged_bev_features")
    model = TerrainNet(cfg_t)
    sd = from_jax_variables(flat)
    model.load_state_dict(sd, strict=True)
    assert set(model.state_dict()) == set(sd)
    w = sd["temporal_layer.rnn.cell_0.conv_gates.weight"]
    assert tuple(w.shape) == (96, 96, 3, 3)
    assert tuple(sd["bevclassifier.mh_conv1.weight"].shape) == (768, 256, 3,
                                                                3)


def _secondary_trees():
    """(name, flat flax tree, port module) of each secondary model: the
    FoundationBackbone at the JAX ViT's defaults (embed 768, depth 12, 12
    heads, patch 14, grid 37), MSNet2D and CnnMLP at the JAX tests'
    configs."""
    from creste_public_tpu.models.blocks.cnnmlp import CnnMLP as JCnnMLP
    from creste_public_tpu.models.foundation import FoundationBackbone as JF
    from creste_public_tpu.models.stereodepth import MSNet2D as JMSNet2D
    from creste_public_tpu_torch.models.blocks.cnnmlp import CnnMLP
    from creste_public_tpu_torch.models.foundation import FoundationBackbone
    from creste_public_tpu_torch.models.stereodepth import MSNet2D
    from tests.test_torch_secondary_models import CNNMLP, FOUNDATION, MSNET

    found = {**FOUNDATION, "vision_backbone": {"backbone_cfgs": {
        "input_shape": [518, 518], "output_shape": [128, 128]}},
        "depth_head": dict(FOUNDATION["depth_head"], dims=[768, 16])}
    cases = [("foundation", JF(found), (np.zeros((1, 1, 64, 80, 4)),),
              lambda: FoundationBackbone(found)),
             ("msnet2d", JMSNet2D(MSNET), (np.zeros((1, 2, 64, 80, 3)),),
              lambda: MSNet2D(MSNET)),
             ("cnnmlp", JCnnMLP(CNNMLP),
              ({"a": np.zeros((1, 8, 8, 2)), "b": np.zeros((1, 8, 8, 4))},),
              lambda: CnnMLP(CNNMLP))]
    for name, jm, args, make in cases:
        tree = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.PRNGKey(0)}, *args))
        flat = {k: np.zeros(v.shape, np.float32)
                for k, v in flatten_dict(dict(tree), sep="/").items()}
        yield name, flat, make


@pytest.mark.parametrize("case", ["foundation", "msnet2d", "cnnmlp"])
def test_weight_import_covers_secondary_trees(case):
    """Every leaf of each secondary model's flax tree lands on one key of
    the port's module, and the module has no other."""
    name, flat, make = next(c for c in _secondary_trees() if c[0] == case)
    sd = from_jax_variables(flat)
    assert len(sd) == len(flat)
    model = make()
    model.load_state_dict(sd, strict=True)
    assert set(model.state_dict()) == set(sd)
    if case == "foundation":
        assert sd["vit.pos_embed"].shape == (1, 37 * 37 + 1, 768)
        assert "vit.block_11.ls2" in sd and "vit.block_12.ls2" not in sd
