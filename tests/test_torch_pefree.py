"""The PE-free multiview branch of stage 1 against the JAX package on the
CPU: the PE map's bilinear resize, the max-mode splat and its gradient,
the BEV-overlap search, ``PEFreeMSELoss``, ``MSELoss(overlap_only)``, the
PE-free ``DistillationBackbone`` in eval and train mode (with and without
``pe_head_bn``), and what a PE-free stage-1 checkpoint does in stage 2.

Tolerances: the resize to RESIZE_RTOL of the largest entry (f32
interpolation weights computed in another order; read ~1e-7), its gradient
likewise; the max splat's features, densities and gradients to SPLAT_RTOL
(the same f32 products; the gradient splits ties evenly on both sides, the
zero floor counted); the overlap search exactly, boundary points at one
voxel +- 1 ulp included; the two losses and their gradients to LOSS_RTOL
(f32 sums in another order); the model's outputs to FORWARD_RTOL (the
EfficientNet trunk's f32 sums, then the max splat of features that differ
by that much: read ~4e-5 at worst, in ``bev_features``).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from creste_public_tpu.config import presets as jpresets
from creste_public_tpu.config.config import Config as JConfig
from creste_public_tpu.data.dataloader import build_dataset as jbuild_dataset
from creste_public_tpu.data.synthetic import collate as jcollate
from creste_public_tpu.losses import manager as jmanager
from creste_public_tpu.models.terrainnet import TerrainNet as JTerrainNet
from creste_public_tpu.ops.splat import splat_bilinear as jsplat
from creste_public_tpu.parallel import make_mesh, shard_batch
from creste_public_tpu.training import optim as joptim
from creste_public_tpu.training import pipelines as jpipelines
from creste_public_tpu.training import surgery as jsurgery
from creste_public_tpu.training.state import TrainState as JTrainState
from creste_public_tpu_torch.config import presets
from creste_public_tpu_torch.config.groups import GROUPS
from creste_public_tpu_torch.losses import manager
from creste_public_tpu_torch.models.distillation import DistillationBackbone
from creste_public_tpu_torch.ops.splat import splat_bilinear
from creste_public_tpu_torch.training import pipelines
from creste_public_tpu_torch.training.surgery import make_stage_loader
from creste_public_tpu_torch.weights import from_jax_variables, init_weights
from tests.test_torch_helpers import jax_variables, seeded_variables
from tests.test_torch_step_helpers import (
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    check_forward_matches_flax,
    multiview_batch,
    seeded_stage_variables,
)

RESIZE_RTOL = 1e-6
SPLAT_RTOL = 1e-6
LOSS_RTOL = 1e-5
FORWARD_RTOL = 1e-3


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("hw, out_hw", [((64, 76), (128, 153)),
                                        ((8, 10), (16, 20))])
def test_pe_map_resize_matches_jax(hw, out_hw):
    """The PE map's bilinear resize, ``F.interpolate(align_corners=False)``
    against ``jax.image.resize(..., "bilinear")``, at the production ratio
    (64x76 -> 128x153, not an integer) and the tiny preset's, edges
    included, and its gradient."""
    rng = np.random.default_rng(0)
    pe = rng.normal(size=(1, *hw, 8)).astype(np.float32)
    cot = rng.normal(size=(1, *out_hw, 8)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jax.image.resize(
        x, (1, *out_hw, 8), "bilinear"), jnp.asarray(pe))
    (want_g,) = vjp(jnp.asarray(cot))
    x = torch.from_numpy(pe.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    got = F.interpolate(x, size=out_hw, mode="bilinear", align_corners=False)
    got.backward(torch.from_numpy(cot.transpose(0, 3, 1, 2).copy()))
    got_nhwc = got.detach().permute(0, 2, 3, 1)
    assert _rel(got_nhwc, want) <= RESIZE_RTOL
    for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        assert _rel(got_nhwc[edge], np.asarray(want)[edge]) <= RESIZE_RTOL
    assert _rel(x.grad.permute(0, 2, 3, 1), want_g) <= RESIZE_RTOL


def _splat_inputs():
    """Two elements of points on a 6x5 grid with planted ties: points on
    integer coordinates (one corner at weight 1, three at 0 against the
    zero floor), masked points (zero features), all-negative features (the
    floor wins), two points with the same coordinates and features (a tie
    between two positive values), and points off the grid."""
    rng = np.random.default_rng(3)
    B, P, Fd = 2, 40, 3
    xy = rng.uniform(-1.0, 6.5, (B, P, 2)).astype(np.float32)
    feats = rng.normal(size=(B, P, Fd)).astype(np.float32)
    xy[:, :6] = np.floor(xy[:, :6])  # integer coordinates
    feats[:, 6:10] = 0.0  # masked points
    feats[:, 10:14] = -np.abs(feats[:, 10:14])  # below the floor
    xy[:, 15] = xy[:, 14]  # a positive tie
    feats[:, 14] = feats[:, 15] = np.abs(feats[:, 14]) + 0.5
    xy[:, 16] = [7.2, 2.0]  # off the grid: every corner invalid
    xy[:, 17] = [-0.5, 4.5]  # half off
    return xy, feats


def test_max_splat_and_gradient_match_jax():
    """``splat_bilinear(mode="max")``: features and densities, and the
    gradient of a random cotangent with respect to the features and the
    coordinates, against ``jax.vjp`` of the JAX op. Both split a tie's
    gradient evenly among the tied updates and the zero floor."""
    xy, feats = _splat_inputs()
    grid = (6, 5)
    cot = np.random.default_rng(4).normal(
        size=(2, grid[0] * grid[1], feats.shape[-1])).astype(np.float32)
    (want_f, want_d), vjp = jax.vjp(
        lambda a, b: jsplat(a, b, grid, mode="max"), jnp.asarray(xy),
        jnp.asarray(feats))
    want_gxy, want_gf = vjp((jnp.asarray(cot), jnp.zeros_like(want_d)))
    txy = torch.from_numpy(xy).requires_grad_(True)
    tf = torch.from_numpy(feats).requires_grad_(True)
    got_f, got_d = splat_bilinear(txy, tf, grid, mode="max")
    got_f.backward(torch.from_numpy(cot))
    assert _rel(got_f, want_f) <= SPLAT_RTOL
    assert _rel(got_d, want_d) <= SPLAT_RTOL
    # the planted ties are there: cells at the zero floor with an update of
    # 0 among their votes, and the positive tie's two points
    assert float((np.asarray(want_f) == 0).mean()) > 0.2
    assert np.array_equal(tf.grad[:, 14].numpy(), tf.grad[:, 15].numpy())
    assert float(tf.grad[:, 14].abs().max()) > 0
    assert _rel(tf.grad, want_gf) <= SPLAT_RTOL
    assert _rel(txy.grad, want_gxy) <= SPLAT_RTOL


def _boundary_coords(rng, B: int, N: int, M: int):
    """Anchor and aug BEV coordinates with aug points planted at distance
    one voxel (the threshold) and one f32 ulp either side of it, along an
    axis and along diagonals, and random ones."""
    anchor = rng.uniform(0, 32, (B, N, 2)).astype(np.float32)
    aug = rng.uniform(0, 32, (B, M, 2)).astype(np.float32)
    one = np.float32(1.0)
    steps = [np.nextafter(one, np.float32(0)), one,
             np.nextafter(one, np.float32(2))]
    k = 0
    for d in steps:
        for angle in (0.0, np.pi / 4, np.pi / 3, 1.1):
            for b in range(B):
                a = anchor[b, k % N]
                aug[b, k] = a + np.array([d * np.cos(angle),
                                          d * np.sin(angle)], np.float32)
            k += 1
    # exact axis offsets from an anchor at the origin of its cell
    anchor[:, 0] = 0.0
    for j, d in enumerate(steps):
        aug[:, k + j] = [d, 0.0]
    return anchor, aug


@pytest.mark.parametrize("chunk", [4096, 7])
def test_bev_overlap_hits_match_jax(chunk):
    """``_bev_overlap_hits`` against the JAX package's and against numpy's
    ``dx*dx + dy*dy < 1`` in f32, exactly, boundary points included; a
    chunk smaller than the anchors gives the same."""
    rng = np.random.default_rng(5)
    anchor, aug = _boundary_coords(rng, 2, 50, 60)
    want = np.asarray(jmanager._bev_overlap_hits(jnp.asarray(anchor),
                                                 jnp.asarray(aug)))
    dx = aug[:, :, None, 0] - anchor[:, None, :, 0]
    dy = aug[:, :, None, 1] - anchor[:, None, :, 1]
    plain = (dx * dx + dy * dy < np.float32(1.0)).any(-1)
    got = manager._bev_overlap_hits(torch.from_numpy(anchor),
                                    torch.from_numpy(aug),
                                    chunk=chunk).numpy()
    assert np.array_equal(want, plain)
    assert np.array_equal(got, want)
    # the axis offsets: 1 - ulp is in, 1 and 1 + ulp are out
    assert got[:, 12].all() and not got[:, 13].any() and not got[:, 14].any()


def test_pefree_mse_matches_jax():
    """``PEFreeMSELoss`` on B=2, V=3 splatted features with densities that
    are zero in places: the loss and its gradient."""
    rng = np.random.default_rng(6)
    B, V, H, W, Z = 2, 3, 8, 8, 4
    pred = rng.normal(size=(B * V, H, W, Z)).astype(np.float32)
    dens = rng.uniform(0, 3, (B * V, H, W, 1)).astype(np.float32)
    dens[dens < 0.8] = 0.0
    cfg = {"name": "PEFreeMSELoss", "num_views": V - 1,
           "pred_key": "outputs/bev_features",
           "lab_key": "outputs/bev_densities", "density_threshold": 1e-3}

    def jloss(p):
        return jmanager.PEFreeMSELoss(cfg)(
            {"outputs/bev_features": p,
             "outputs/bev_densities": jnp.asarray(dens)})[0]["loss"][1]

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_(True)
    ld, meta = manager.make_loss(cfg)({"outputs/bev_features": tp,
                                       "outputs/bev_densities":
                                       torch.from_numpy(dens)})
    (w, got), = ld.values()
    assert w == 1.0 and not meta
    got.backward()
    assert _rel(got, want) <= LOSS_RTOL
    assert _rel(tp.grad, want_g) <= LOSS_RTOL


@pytest.mark.parametrize("V", [1, 3])
def test_overlap_mse_matches_jax(V):
    """``MSELoss(overlap_only)``: the anchor view's MSE plus, per element,
    the MSE over aug-view pixels within one voxel of an anchor pixel in
    BEV, summed over the batch; labels with inf padding, boundary
    coordinates planted, an element without overlap; the loss and its
    gradient."""
    rng = np.random.default_rng(7)
    B, H, W, Z = 3, 6, 10, 4
    pred = rng.normal(size=(B, V, H, W, Z)).astype(np.float32)
    gt = rng.normal(size=(B, V, H, W, Z)).astype(np.float32)
    gt[0, :, 0, :3] = np.inf
    anchor, aug = _boundary_coords(rng, B, H * W, max(V - 1, 1) * H * W)
    coords = np.concatenate([anchor[:, None], aug.reshape(B, -1, H * W, 2)
                             [:, :V - 1]], 1).reshape(B * V, H * W, 2)
    if V > 1:
        coords[(B - 1) * V + 1:B * V] += 1000.0  # no overlap
    cfg = {"name": "MSELoss", "pred_key": "outputs/dino_pe_feats",
           "lab_key": "inputs/fimg_label", "overlap_only": True}
    jtd = {"inputs/fimg_label": jnp.asarray(gt),
           "outputs/bev_coords": jnp.asarray(coords)}

    def jloss(p):
        td = dict(jtd, **{"outputs/dino_pe_feats": p})
        return jmanager.MSELoss(cfg)(td)[0]["loss"][1]

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_(True)
    ld, _ = manager.make_loss(cfg)({
        "outputs/dino_pe_feats": tp,
        "inputs/fimg_label": torch.from_numpy(gt),
        "outputs/bev_coords": torch.from_numpy(coords)})
    got = ld["loss"][1]
    got.backward()
    assert _rel(got, want) <= LOSS_RTOL
    assert _rel(tp.grad, want_g) <= LOSS_RTOL


def _pefree_run(use_norm: bool) -> dict:
    """A step-harness ``run`` of the PE-free tiny preset (V=2) at seeded
    weights, for the forward check."""
    cfg = presets.tiny_pefree_config().to_dict()
    cfg["pe_map"]["use_norm"] = use_norm
    b = multiview_batch()
    jm = jpipelines.build_model("distillation", cfg)
    v = jax_variables(seeded_stage_variables(jm, b))
    state = types.SimpleNamespace(params=v["params"],
                                  batch_stats=v["batch_stats"])
    return dict(stage="distillation", cfg=cfg, batches=[b], masks=[],
                states=[state])


@pytest.mark.parametrize("use_norm", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_pefree_backbone_matches_flax(use_norm, train):
    """The PE-free multiview DistillationBackbone (B=2, V=2) in eval and
    train mode, with and without ``pe_head_bn``: every output (``dino_pe``,
    ``dino_pefree_feats``, ``dino_pe_feats``, the depth keys and the max
    splat's ``bev_*``) and, in train mode, every staged statistic."""
    model = check_forward_matches_flax(_pefree_run(use_norm), train,
                                       FORWARD_RTOL)
    assert isinstance(model, DistillationBackbone)
    assert model.cam2map.scatter_mode == "max"
    assert (model.pe_head_bn is not None) == use_norm
    assert tuple(model.learnable_pe_map.shape) == (1, 8, 8, 10)


def test_pe_map_weights_and_init():
    """``from_jax_variables`` carries the flax NHWC map into the port's
    NCHW parameter, and ``init_weights`` gives it a seeded 0.05 N."""
    pe = np.random.default_rng(8).normal(size=(1, 4, 5, 3)).astype(
        np.float32)
    sd = from_jax_variables({"params/learnable_pe_map": pe})
    assert np.array_equal(sd["learnable_pe_map"].numpy(),
                          pe.transpose(0, 3, 1, 2))
    cfg = presets.tiny_pefree_config().to_dict()
    a = init_weights(DistillationBackbone(cfg), 0).learnable_pe_map
    b = init_weights(DistillationBackbone(cfg), 0).learnable_pe_map
    c = init_weights(DistillationBackbone(cfg), 1).learnable_pe_map
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 0.03 < float(a.detach().std()) < 0.07


def test_pefree_checkpoint_into_stage2(tmp_path):
    """A PE-free stage-1 checkpoint in stage 2, as the JAX package has it:
    its graft puts the PE map, the PE head and the multiview splat under
    TerrainNet's ``depthcomp``, which has none of them, and its first
    training step then raises (the optimizer's tree lacks them). The port
    refuses at the graft, naming them, and leaves the model as it was; a
    single-view stage-1 checkpoint grafts."""
    b = multiview_batch(B=1, V=1)
    cfg1 = jpresets.tiny_pefree_config()
    stage1 = seeded_stage_variables(jpipelines.build_model(
        "distillation", cfg1), multiview_batch(B=1, V=2))
    cfg2 = jpresets.tiny_terrainnet_config()
    jm2 = JTerrainNet(cfg2)
    v2 = jax_variables(seeded_variables(jm2, b["image"], b["p2p"]))
    tx = joptim.make_optimizer(cfg2["optimizer"], cfg2["lr_scheduler"], 2)
    state = JTrainState.create(v2["params"], v2["batch_stats"], tx)
    raw = jax_variables(stage1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsurgery, "load_raw_checkpoint", lambda path: raw)
        grafted = jsurgery.make_stage_loader("ssc", "unused")(state)
    assert {"learnable_pe_map", "pe_head_conv", "cam2map"} <= set(
        grafted.params["depthcomp"])
    mesh = make_mesh(1)
    step = jpipelines.make_train_step(
        "ssc", jm2, jmanager.LossManager(cfg2), tx, mesh, task="joint",
        donate=False)
    ds = jbuild_dataset(JConfig(GROUPS["dataset"]["synthetic_tiny"]), "train")
    batch = jcollate([ds[0]])
    with pytest.raises(ValueError, match="key mismatch"):
        step(grafted, shard_batch(batch, mesh), jax.random.PRNGKey(0))

    # the port: the same checkpoint refused at the graft
    model1 = DistillationBackbone(presets.tiny_pefree_config().to_dict())
    model1.load_state_dict(from_jax_variables(stage1), strict=True)
    d1 = tmp_path / "pefree" / "step_1"
    d1.mkdir(parents=True)
    torch.save({"step": 1, "model": model1.state_dict()}, d1 / "state.pt")
    model2, _, s2 = pipelines.init_stage(
        "ssc", GROUPS["model"]["ssc_sam/tiny"], device="cpu")
    before = {k: v.clone() for k, v in model2.state_dict().items()}
    with pytest.raises(ValueError, match="learnable_pe_map") as err:
        make_stage_loader("ssc", str(tmp_path / "pefree"))(s2)
    assert "cam2map" in str(err.value) and "pe_head_conv" in str(err.value)
    for k, v in model2.state_dict().items():
        assert torch.equal(v, before[k]), k
    single = DistillationBackbone(GROUPS["model"]["distillation/tiny"])
    ckpt_dir = tmp_path / "single" / "step_2"
    ckpt_dir.mkdir(parents=True)
    torch.save({"step": 2, "model": single.state_dict()},
               ckpt_dir / "state.pt")
    make_stage_loader("ssc", str(tmp_path / "single"))(s2)
    for k, v in single.state_dict().items():
        assert torch.equal(model2.state_dict()[f"depthcomp.{k}"], v), k
