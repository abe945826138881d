"""The port's temporal branch against the JAX package's on the CPU: the
pose warp (``ops/warp.py``), ``ConvGRU`` and ``MergeUnit``
(``models/blocks/convgru.py``), ``SequenceChunkLoader``, TerrainNet with
``use_temporal`` and two chunks of ``make_temporal_train_step``.

Weights are seeded flax-shaped trees (``seeded_variables``, BatchNorms
jittered); inputs and poses are seeded numpy arrays; the pose noise and
SupCon's priorities are fed to both sides (a test-local
``jax.random.normal`` and ``uniform`` return them; the step's trunk, at
``stage_repeats=1``, draws no drop-connect mask). Tolerances, each as
max|d| over the reference's largest entry:

* each warp op to WARP_RTOL = 1e-6 from the same input: the relative
  affine, the effective pixel affine (both through a matrix inverse that
  rounds apart by a few 1e-7), the noise, and the bilinear sampling from
  JAX's own effective affine. The whole warp from M carries the inverse's
  rounding into the sampling coordinates (up to ~5e-7 of a coordinate of
  20 pixels, times the map's slope): WARP_E2E_RTOL = 5e-6, below the 1e-5
  that the JAX package states for its f32 warp against the f64
  reference. The gradients to GRAD_RTOL;
* ConvGRU and MergeUnit outputs and hidden states to FWD_RTOL = 1e-5
  (convolutions, sigmoids and the warp's gather over two chunks in f32 in
  another order), every gradient to GRAD_RTOL = 1e-4 (the same backward
  through up to four recurrent steps);
* ``SequenceChunkLoader`` bit-equal;
* the temporal TerrainNet's train-mode forward to STAGE_RTOL = 1e-3 and
  the two-chunk step's loss and metrics to METRIC_RTOL = 1e-4, its new
  hidden state to STAGE_RTOL: the drift of the stage-2 model end to end,
  as ``tests/test_torch_ssc_step.py`` holds it. A control: the second
  chunk from a zeroed hidden state moves the new hidden state by more
  than CARRY_BAR of its largest entry.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax.sharding import NamedSharding, PartitionSpec as P

from creste_public_tpu.data.dataloader import (
    SequenceChunkLoader as JChunkLoader,
)
from creste_public_tpu.data.synthetic import SyntheticCodaDataset as JSynth
from creste_public_tpu.losses import LossManager as JLossManager
from creste_public_tpu.models.blocks.convgru import ConvGRU as JConvGRU
from creste_public_tpu.models.blocks.convgru import MergeUnit as JMergeUnit
from creste_public_tpu.models.terrainnet import TerrainNet as JTerrainNet
from creste_public_tpu.ops import warp as jwarp
from creste_public_tpu.parallel import make_mesh, shard_batch
from creste_public_tpu.training import optim as joptim
from creste_public_tpu.training import pipelines as jpipelines
from creste_public_tpu.training.state import TrainState as JTrainState
from creste_public_tpu_torch.config.groups import GROUPS
from creste_public_tpu_torch.data.dataloader import SequenceChunkLoader
from creste_public_tpu_torch.data.synthetic import SyntheticCodaDataset
from creste_public_tpu_torch.models.blocks.convgru import ConvGRU, MergeUnit
from creste_public_tpu_torch.models.terrainnet import TerrainNet
from creste_public_tpu_torch.ops import warp
from creste_public_tpu_torch.training import pipelines
from creste_public_tpu_torch.training.loop import to_device
from creste_public_tpu_torch.weights import from_jax_variables
from tests.test_torch_helpers import jax_variables, jitter_bn, seeded_variables
from tests.test_torch_step_helpers import (
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    flat_state,
    rel,
)

WARP_RTOL = 1e-6
WARP_E2E_RTOL = 5e-6
FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
STAGE_RTOL = 1e-3
METRIC_RTOL = 1e-4
CARRY_BAR = 1e-3
CPU = torch.device("cpu")


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _se2(rng, scale=6.0):
    th = rng.uniform(-0.4, 0.4)
    p = np.eye(4)
    p[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
    p[0, 3], p[1, 3] = rng.uniform(-scale, scale, 2)
    p[2, 3] = rng.uniform(-0.5, 0.5)
    return p


def _trajectory(B, T, seed=0):
    """[B, T, 4, 4] smooth SE(3) trajectories (turning, moving a few
    BEV pixels per frame, changing height)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((B, T, 4, 4))
    for b in range(B):
        x0, y0 = rng.uniform(-2, 2, 2)
        for t in range(T):
            th = 0.12 * t + 0.05 * b
            q = np.eye(4)
            q[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
            q[0, 3], q[1, 3], q[2, 3] = x0 + 1.5 * t, y0 - 0.8 * t, 0.3 * t
            out[b, t] = q
    return out.astype(np.float32)


@pytest.mark.parametrize("hw", [(12, 20), (9, 31)])
def test_warp_ops_match_jax(hw):
    """The relative affine, its effective pixel affine, the warp with its
    mask, the noise, and the warp's gradient in the map and in the affine
    (through the inverse), at non-square sizes."""
    rng = np.random.default_rng(sum(hw))
    H, W = hw
    B, C = 3, 5
    inp = np.stack([_se2(rng) for _ in range(B)]).astype(np.float32)
    cell = np.stack([_se2(rng) for _ in range(B)]).astype(np.float32)
    M = np.asarray(jwarp.relative_bev_affine(jnp.asarray(inp),
                                             jnp.asarray(cell)))
    got = warp.relative_bev_affine(torch.from_numpy(inp),
                                   torch.from_numpy(cell))
    assert _rel(got, M) <= WARP_RTOL
    assert torch.equal(warp.se2_of_pose(torch.from_numpy(inp)),
                       torch.from_numpy(np.asarray(jwarp.se2_of_pose(
                           jnp.asarray(inp)))))
    Mt = torch.from_numpy(M)
    assert _rel(warp.effective_pixel_affine(Mt, (H, W)),
                jwarp.effective_pixel_affine(jnp.asarray(M), (H, W))) \
        <= WARP_RTOL
    rot = rng.normal(size=(B,)).astype(np.float32)
    trans = rng.normal(size=(B, 2)).astype(np.float32)
    assert _rel(warp.noisify_affine(Mt, torch.from_numpy(rot),
                                    torch.from_numpy(trans)),
                jwarp.noisify_affine(jnp.asarray(M), jnp.asarray(rot),
                                     jnp.asarray(trans))) <= WARP_RTOL

    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    cot = rng.normal(size=(B, H, W, C)).astype(np.float32)
    # op by op, as the JAX module runs outside a jit (inside one, XLA
    # fuses the sampling coordinates' multiply-adds)
    A = torch.from_numpy(np.asarray(jwarp.effective_pixel_affine(
        jnp.asarray(M), (H, W))))
    for with_mask in (True, False):
        want, want_m = jwarp.affine_warp(jnp.asarray(x), jnp.asarray(M),
                                         with_mask)
        out, mask = warp.sample_affine(torch.from_numpy(x), A, with_mask)
        assert _rel(out, want) <= WARP_RTOL
        assert torch.equal(mask, torch.from_numpy(np.asarray(want_m)))
        out, mask = warp.affine_warp(torch.from_numpy(x), Mt, with_mask)
        assert _rel(out, want) <= WARP_E2E_RTOL
        assert torch.equal(mask, torch.from_numpy(np.asarray(want_m)))
    assert mask.all() and not torch.equal(mask, warp.affine_warp(
        torch.from_numpy(x), Mt)[1])

    def jf(x_, m_):
        return jnp.sum(jwarp.affine_warp(x_, m_)[0] * cot)

    gx, gm = jax.jit(jax.grad(jf, argnums=(0, 1)))(jnp.asarray(x),
                                                    jnp.asarray(M))
    xt = torch.from_numpy(x).requires_grad_(True)
    mt = Mt.clone().requires_grad_(True)
    (warp.affine_warp(xt, mt)[0] * torch.from_numpy(cot)).sum().backward()
    assert _rel(xt.grad, gx) <= GRAD_RTOL
    assert _rel(mt.grad, gm) <= GRAD_RTOL


# ConvGRU configurations: (hidden_dims, kernel, cell_type, use_pose,
# noisy_pose, use_z)
GRU_CASES = {
    "mru_3x3_two_layers": ((6, 4), (3, 3), "MRU", False, False, False),
    "simple": ((5,), (1, 1), "simple", False, False, False),
    "pose_noisy_z": ((6,), (3, 3), "GRU", True, True, True),
    "pose_noisy_two_layers": ((6, 4), (1, 1), "GRU", True, True, False),
}


class _FedNormal:
    """A ``jax.random.normal`` that returns the fed draws in call order
    (each traced forward draws (rotation, translation) per layer)."""

    def __init__(self, draws):
        self.draws = [a for pair in draws for a in pair]
        self.calls = 0

    def __call__(self, key, shape, *args, **kwargs):
        a = self.draws[self.calls % len(self.draws)]
        self.calls += 1
        assert tuple(shape) == a.shape
        return jnp.asarray(a)


def _noise_draws(L, B, T, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(B, T)).astype(np.float32),
             rng.normal(size=(B, T, 2)).astype(np.float32))
            for _ in range(L)]


@pytest.mark.parametrize("case", list(GRU_CASES))
def test_convgru_two_chunks_match_jax(case, monkeypatch):
    """Two chunks, the second from the first's hidden state (and cell
    pose): every output, each layer's final hidden entry, and the
    gradient of both chunks' outputs in every parameter and in the input."""
    hidden_dims, kernel, cell_type, use_pose, noisy, use_z = GRU_CASES[case]
    B, T, H, W, C = 2, 3, 10, 12, 5
    rng = np.random.default_rng(len(case))
    x1, x2 = (rng.normal(0, 0.5, (B, T, H, W, C)).astype(np.float32)
              for _ in range(2))
    pose = _trajectory(B, 2 * T, seed=3)
    p1, p2 = pose[:, :T], pose[:, T:]
    draws = _noise_draws(len(hidden_dims), B, T, seed=4)
    jm = JConvGRU(hidden_dims=hidden_dims, kernel=kernel,
                  cell_type=cell_type, use_pose=use_pose, noisy_pose=noisy,
                  use_z=use_z)
    rngs = {"noise": jax.random.PRNGKey(1)}
    pj = dict(pose=jnp.asarray(p1)) if use_pose else {}
    flat = seeded_variables(jm, jnp.asarray(x1), init=lambda r, x: jm.init(
        dict(r, **rngs), x, **pj), seed=5)
    # biases too, so that every parameter carries a gradient of its own
    flat = {k: (v + 0.1 * rng.normal(size=v.shape).astype(np.float32)
                if k.endswith("bias") else v) for k, v in flat.items()}
    monkeypatch.setattr(jax.random, "normal", _FedNormal(draws))
    c1, c2 = (rng.normal(size=(B, T, H, W, hidden_dims[-1])).astype(
        np.float32) for _ in range(2))

    def jrun(params, x1_, x2_):
        kw1 = dict(pose=jnp.asarray(p1)) if use_pose else {}
        kw2 = dict(pose=jnp.asarray(p2)) if use_pose else {}
        v = {"params": params}
        ys1, f1 = jm.apply(v, x1_, rngs=rngs, **kw1)
        ys2, f2 = jm.apply(v, x2_, hidden=f1, rngs=rngs, **kw2)
        total = jnp.sum(ys1 * c1) + jnp.sum(ys2 * c2)
        return total, (ys1, ys2, f1, f2)

    params = jax_variables(flat).get("params", {})
    (_, (ys1, ys2, f1, f2)), (g_p, g_x1, g_x2) = jax.jit(jax.value_and_grad(
        jrun, argnums=(0, 1, 2), has_aux=True))(
        params, jnp.asarray(x1), jnp.asarray(x2))

    model = ConvGRU(C, hidden_dims, kernel, cell_type, use_pose, noisy, use_z)
    model.load_state_dict(from_jax_variables(flat), strict=True)
    xt1, xt2 = (torch.from_numpy(a).requires_grad_(True) for a in (x1, x2))
    noise = [(torch.from_numpy(r), torch.from_numpy(t)) for r, t in draws]
    kw1 = dict(pose=torch.from_numpy(p1), noise=noise) if use_pose else {}
    kw2 = dict(pose=torch.from_numpy(p2), noise=noise) if use_pose else {}
    ty1, tf1 = model(xt1, **kw1)
    ty2, tf2 = model(xt2, hidden=tf1, **kw2)
    ((ty1 * torch.from_numpy(c1)).sum()
     + (ty2 * torch.from_numpy(c2)).sum()).backward()

    assert _rel(ty1, ys1) <= FWD_RTOL and _rel(ty2, ys2) <= FWD_RTOL
    for got, want in zip(tf2, f2):
        if use_pose:
            assert _rel(got[0], want[0]) <= FWD_RTOL
            assert torch.equal(got[1], torch.from_numpy(p2[:, -1]))
            assert bool(got[2].all()) and bool(np.asarray(want[2]).all())
        else:
            assert _rel(got, want) <= FWD_RTOL
    assert _rel(xt1.grad, g_x1) <= GRAD_RTOL
    assert _rel(xt2.grad, g_x2) <= GRAD_RTOL
    want_g = from_jax_variables(flatten_dict({"params": g_p}, sep="/"))
    named = dict(model.named_parameters())
    assert set(want_g) == set(named)
    for k, g in want_g.items():
        assert _rel(named[k].grad, g.numpy()) <= GRAD_RTOL, k
    if noisy:
        with pytest.raises(ValueError, match="noise"):
            model(xt1, pose=torch.from_numpy(p1))


MERGE_CASES = {
    "gru_groups2": {"rnn_input_channels": 8, "rnn_config": {
        "hidden_dims": [8], "groups": 2, "cell_type": "GRU",
        "kernel_size": [3, 3]}},
    "pose_noisy": {"rnn_input_channels": 6, "rnn_config": {
        "hidden_dims": [6], "groups": 1, "cell_type": "GRU",
        "kernel_size": [1, 1], "use_pose": True, "noisy_pose": True}},
    "pose_groups2_z": {"rnn_config": {
        "hidden_dims": [6], "groups": 2, "cell_type": "MRU",
        "kernel_size": [1, 1], "use_pose": True, "use_z": True}},
    "force_bos": {"rnn_input_channels": 6, "rnn_config": {
        "hidden_dims": [6], "force_bos": True}},
    "no_rnn": {"rnn_input_channels": 6},
}


@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_merge_unit_matches_jax(case, monkeypatch):
    """MergeUnit in train mode over a begin-of-sequence chunk and a
    carried one: the merged features, the hidden state (out of the graph
    on the port's side, as JAX's stop_gradient), the pre-RNN BatchNorm's
    staged statistics and the gradient of the second chunk's features in
    every parameter and the input."""
    cfg = MERGE_CASES[case]
    rnn_cfg = cfg.get("rnn_config") or {}
    use_pose = rnn_cfg.get("use_pose", False)
    b, t, H, W, C = 2, 2, 8, 10, 6
    rng = np.random.default_rng(11 + len(case))
    x1, x2 = (rng.normal(0, 0.5, (b * t, H, W, C)).astype(np.float32)
              for _ in range(2))
    pose = _trajectory(b, 2 * t, seed=6)
    p1, p2 = (pose[:, s:s + t].reshape(b * t, 4, 4) for s in (0, t))
    groups = int(rnn_cfg.get("groups", 1))
    draws = _noise_draws(1, b * groups, t, seed=7)
    monkeypatch.setattr(jax.random, "normal", _FedNormal(draws))
    jm = JMergeUnit(cfg)
    rngs = {"noise": jax.random.PRNGKey(2)}
    kw1 = dict(pose=jnp.asarray(p1)) if use_pose else {}
    flat = jitter_bn(seeded_variables(jm, jnp.asarray(x1), init=lambda r, x:
                                      jm.init(dict(r, **rngs), x, t=t,
                                              train=True, **kw1), seed=8))
    c_out = (int(rnn_cfg["hidden_dims"][-1]) if rnn_cfg
             else int(cfg.get("rnn_input_channels", C)))
    cot = rng.normal(size=(b * t, H, W, c_out)).astype(np.float32)

    def jrun(params, x2_):
        v = {"params": params, "batch_stats": jax_variables(flat).get(
            "batch_stats", {})}
        out1, mut1 = jm.apply(v, jnp.asarray(x1), t=t, train=True, bos=True,
                              rngs=rngs, mutable=["batch_stats"], **kw1)
        kw2 = dict(pose=jnp.asarray(p2)) if use_pose else {}
        if rnn_cfg:
            out1, hid = out1
            out2, _ = jm.apply(v, x2_, t=t, train=True, bos=False,
                               hidden=hid, rngs=rngs,
                               mutable=["batch_stats"], **kw2)
            out2, hid2 = out2
        else:
            out2, _ = jm.apply(v, x2_, t=t, train=True,
                               mutable=["batch_stats"])
            hid = hid2 = None
        return jnp.sum(out2 * cot), (out1, out2, hid, hid2, mut1)

    params = jax_variables(flat)["params"]
    (_, (o1, o2, h1, h2, mut1)), (g_p, g_x2) = jax.jit(jax.value_and_grad(
        jrun, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x2))

    model = MergeUnit(cfg, C)
    model.load_state_dict(from_jax_variables(flat), strict=True)
    model.train()
    noise = [(torch.from_numpy(r), torch.from_numpy(tr)) for r, tr in draws]
    tkw1 = dict(pose=torch.from_numpy(p1), noise=noise) if use_pose else {}
    tkw2 = dict(pose=torch.from_numpy(p2), noise=noise) if use_pose else {}
    xt2 = torch.from_numpy(x2).requires_grad_(True)
    out1 = model(torch.from_numpy(x1), t=t, bos=True, **tkw1)
    staged = model.pre_rnn_bn.staged if model.pre_rnn else None
    if rnn_cfg:
        out1, hid = out1
        out2, hid2 = model(xt2, t=t, hidden=hid, bos=False, **tkw2)
    else:
        out2 = model(xt2, t=t)
    (out2 * torch.from_numpy(cot)).sum().backward()

    assert _rel(out1, o1) <= FWD_RTOL and _rel(out2, o2) <= FWD_RTOL
    if rnn_cfg:
        for got, want in ((hid, h1), (hid2, h2)):
            for g, w in zip(got, want):
                g0, w0 = (g[0], w[0]) if use_pose else (g, w)
                assert g0.grad_fn is None and not g0.requires_grad
                assert _rel(g0, w0) <= FWD_RTOL
    if staged is not None:
        for got, leaf in zip(staged, ("mean", "var")):
            assert _rel(got, mut1["batch_stats"]["pre_rnn_bn"][leaf]) \
                <= FWD_RTOL
    assert _rel(xt2.grad, g_x2) <= GRAD_RTOL
    want_g = from_jax_variables(flatten_dict({"params": g_p}, sep="/"))
    named = dict(model.named_parameters())
    for k, g in want_g.items():
        ref = g.numpy()
        if np.abs(ref).max() == 0:  # a bias the train-mode BN subtracts
            assert named[k].grad is None or float(
                named[k].grad.abs().max()) <= 1e-6, k
            continue
        assert _rel(named[k].grad, ref) <= GRAD_RTOL, k


def _synth(cls):
    return cls(length=8, image_size=(64, 80), ds=4, grid=32, map_range=1.6,
               fdn_dim=16, horizon=10)


@pytest.mark.parametrize("shuffle", [False, True])
def test_sequence_chunk_loader_bit_equal(shuffle):
    """Both loaders over the same synthetic dataset: every chunk of two
    epochs, key by key, to the bit, with the ``bos`` flags."""
    kw = dict(batch_size=2, seq_len=4, chunk_len=2, shuffle=shuffle, seed=3)
    jl = JChunkLoader(_synth(JSynth), **kw)
    tl = SequenceChunkLoader(_synth(SyntheticCodaDataset), **kw)
    assert len(tl) == len(jl) == 2
    for epoch in (0, 1):
        want, got = list(jl.epoch(epoch)), list(tl.epoch(epoch))
        assert len(got) == len(want) == 2
        assert [bool(c["bos"][0]) for c in got] == [True, False]
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                if isinstance(w[k], dict):
                    for kk in w[k]:
                        np.testing.assert_array_equal(g[k][kk], w[k][kk])
                else:
                    assert g[k].dtype == w[k].dtype, k
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert got[0]["image"].shape == (2, 2, 64, 80, 4)
    with pytest.raises(ValueError, match="divisible"):
        SequenceChunkLoader(_synth(SyntheticCodaDataset), 2, 4, 3)


B, T = 2, 2
KEYS = ("image", "depth_label", "fimg_label", "p2p", "fov_mask",
        "3d_sam_label", "3d_sam_dynamic_label", "elevation_label")


def temporal_cfg(use_pose: bool = True) -> dict:
    """The tiny stage-2 preset (trunk at stage_repeats=1: the branch is
    after the backbone, whose drop-connect ``tests/test_torch_ssc_step.py``
    holds) with the temporal layer of the JAX package's temporal-training
    test, the pose warp with noise on, and the decoder on the merged
    features."""
    cfg = copy.deepcopy(GROUPS["model"]["ssc_sam/tiny"])
    cfg["vision_backbone"]["effnet_cfgs"]["stage_repeats"] = 1
    cfg["use_temporal"] = True
    cfg["temporal_layer"] = {"net_kwargs": {
        "rnn_input_channels": 16,
        "rnn_config": {"hidden_dims": [16], "groups": 1, "cell_type": "GRU",
                       "kernel_size": [1, 1], "use_pose": use_pose,
                       "noisy_pose": use_pose}}}
    cfg["bev_classifier"]["net_kwargs"]["input_key"] = "merged_bev_features"
    return cfg


def _chunks() -> list[dict]:
    """The two chunks of one window (B=2 sequences of 4 frames, chunks of
    2), each with its frames' poses."""
    loader = JChunkLoader(_synth(JSynth), batch_size=B, seq_len=4,
                          chunk_len=T, shuffle=False)
    pose = _trajectory(B, 2 * T, seed=9)
    out = []
    for c, chunk in enumerate(loader.epoch(0)):
        out.append(dict({k: chunk[k] for k in KEYS},
                        pose=pose[:, c * T:(c + 1) * T]))
    return out


@pytest.fixture(scope="module")
def temporal_run():
    """JAX's carried step (``bos=False``, one compile): on chunk 0 from
    the seeded state and a fresh template (h zeros, every entry invalid:
    the first frame keeps h unwarped, so this is the bos step's forward,
    loss and hidden state), then on chunk 1 from chunk 0's hidden
    state."""
    cfg = temporal_cfg()
    chunks = _chunks()
    jm = JTerrainNet(cfg)
    rngs = {"noise": jax.random.PRNGKey(3)}
    c0 = chunks[0]
    flat = jitter_bn(seeded_variables(
        jm, c0["image"], c0["p2p"], init=lambda r, img, p2p: jm.init(
            dict(r, **rngs), img, p2p, None, train=False,
            pose=jnp.asarray(c0["pose"]))))
    variables = jax_variables(flat)
    tx = joptim.make_optimizer(cfg["optimizer"], cfg["lr_scheduler"], 2)
    mesh = make_mesh(1)
    state = jax.device_put(JTrainState.create(
        variables["params"], variables["batch_stats"], tx),
        NamedSharding(mesh, P()))
    lm = JLossManager(cfg)
    n_pri = c0["3d_sam_label"].size
    pri = np.random.default_rng(8).uniform(size=n_pri).astype(np.float32)
    draws = _noise_draws(1, B, T, seed=10)

    hd = 16
    Hg = c0["fov_mask"].shape[-1]
    template = [(jnp.zeros((B, Hg, Hg, hd)), jnp.zeros((B, 4, 4)),
                 jnp.zeros((B,), bool))]
    key = jax.random.PRNGKey(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", _fed_uniform_fn(pri))
        mp.setattr(jax.random, "normal", _FedNormal(draws))
        step_mid = jpipelines.make_temporal_train_step(
            jm, lm, tx, mesh, task="joint", bos=False)
        # the template placed as the step places its hidden output, so
        # that every call reuses the one compile
        s1, m0, h1 = step_mid(state, shard_batch(chunks[0], mesh), key,
                              shard_batch(template, mesh))
        s2, m1, h2 = step_mid(s1, shard_batch(chunks[1], mesh), key, h1)
    return dict(cfg=cfg, chunks=chunks, pri=pri, draws=draws,
                states=[state, s1, s2],
                hidden=jax.tree_util.tree_map(np.array, (h1, h2)),
                metrics=[{k: float(v) for k, v in m.items()}
                         for m in (m0, m1)])


def _fed_uniform_fn(pri):
    def uniform(key, shape, *args, **kwargs):
        assert tuple(shape) == pri.shape
        return jnp.asarray(pri)
    return uniform


def _port_state(run, t):
    model, lm, state = pipelines.init_stage("ssc", run["cfg"],
                                            steps_per_epoch=2, device="cpu")
    model.load_state_dict(from_jax_variables(flat_state(run["states"][t])),
                          strict=True)
    return model, lm, state


def _hidden(h) -> list:
    return [tuple(torch.from_numpy(np.array(a)) for a in h[0])]


def _port_step(run, t, hidden, bos):
    model, lm, state = _port_state(run, t)
    step = pipelines.make_temporal_train_step(model, lm, task="joint")
    noise = [tuple(torch.from_numpy(a) for a in run["draws"][0])]
    _, metrics, new_hidden = step(
        state, to_device(run["chunks"][t], CPU), hidden, bos, None,
        priorities=torch.from_numpy(run["pri"]),
        pose_noise=noise)
    return model, metrics, new_hidden


def test_two_chunk_temporal_step_matches_jax(temporal_run):
    """The port's step from the JAX state before each chunk: chunk 0 at
    bos (the hidden state it is handed is ignored), chunk 1 from JAX's
    carried hidden state. The loss and every metric, the new hidden state
    (h, the cell pose, the valid flag) and, after the first step, the
    running statistics; then the zero-carry control."""
    run = temporal_run
    garbage = [tuple(torch.full_like(a, 7.0) if a.is_floating_point()
                     else a for a in _hidden(run["hidden"][0])[0])]
    model, m0, h1 = _port_step(run, 0, garbage, True)
    _, m1, h2 = _port_step(run, 1, _hidden(run["hidden"][0]), False)
    _, m1z, h2z = _port_step(run, 1, [tuple(torch.zeros_like(a) for a in
                                           _hidden(run["hidden"][0])[0])],
                             False)
    for got, want in zip((m0, m1), run["metrics"]):
        assert got.keys() == want.keys()
        for k, ref in want.items():
            np.testing.assert_allclose(float(got[k]), ref, rtol=METRIC_RTOL,
                                       atol=1e-7, err_msg=k)
    for got, want in ((h1, run["hidden"][0]), (h2, run["hidden"][1])):
        (h, cell_pose, valid), = got
        assert h.grad_fn is None and not h.requires_grad
        assert rel(h, want[0][0]) <= STAGE_RTOL
        assert torch.equal(cell_pose, torch.from_numpy(want[0][1]))
        assert bool(valid.all()) and bool(want[0][2].all())
    # the running statistics the first step committed
    sd = model.state_dict()
    want_s = from_jax_variables({k: v for k, v in flat_state(
        run["states"][1]).items() if k.startswith("batch_stats")})
    for k, ref in want_s.items():
        assert rel(sd[k], ref.numpy()) <= METRIC_RTOL, k
    # the control: the carry moves the second chunk's hidden state
    a, b_ = h2[0][0].numpy(), h2z[0][0].numpy()
    assert np.abs(a - b_).max() > CARRY_BAR * np.abs(a).max()
    assert np.isfinite(float(m1z["loss"]))


def test_temporal_chain_and_no_pose_branch(temporal_run):
    """The port's own two chunks chained (its hidden state carried, a
    torch.Generator for masks, priorities and pose noise) stay finite and
    carry; without ``use_pose`` (and with the learnable loss weight) the
    temporal TerrainNet trains from a plain hidden list, and ``use_pose``
    without a pose raises."""
    run = temporal_run
    model, lm, state = _port_state(run, 0)
    step = pipelines.make_temporal_train_step(model, lm, task="joint")
    c0, c1 = (to_device(c, CPU) for c in run["chunks"])
    hidden = pipelines.init_temporal_hidden(model, c0)
    assert all(not bool(a.any()) for a in hidden[0])
    g = torch.Generator().manual_seed(0)
    _, m0, hidden = step(state, c0, hidden, True, g)
    _, m1, hidden = step(state, c1, hidden, False, g)
    assert state.step == 2 and float(hidden[0][0].abs().max()) > 0
    assert all(bool(torch.isfinite(v)) for m in (m0, m1) for v in m.values())
    with pytest.raises(ValueError, match="pose"):
        model.eval()(c0["image"], c0["p2p"])

    cfg = temporal_cfg(use_pose=False)
    cfg["bev_classifier"]["net_kwargs"]["learnable_loss_weight"] = True
    plain = pipelines.init_stage("ssc", cfg, steps_per_epoch=2,
                                 device="cpu")
    pstep = pipelines.make_temporal_train_step(*plain[:2], task="joint")
    no_pose = {k: v for k, v in c0.items() if k != "pose"}
    h = pipelines.init_temporal_hidden(plain[0], no_pose)
    assert isinstance(h[0], torch.Tensor)
    _, m, h = pstep(plain[2], no_pose, h, True, g)
    assert h[0].shape == (B, 32, 32, 16) and float(h[0].abs().max()) > 0
    assert np.isfinite(float(m["loss"])) and plain[2].step == 1
    assert "log_var" in dict(plain[0].bevclassifier.named_parameters())


def _save(model, path, step=3):
    path.mkdir(parents=True)
    torch.save({"step": step, "model": model.state_dict()}, path / "state.pt")
    return str(path)


def test_surgery_with_temporal_layer_and_log_var(tmp_path):
    """Checkpoints that carry ``temporal_layer`` and the decoder's
    ``log_var`` load as the JAX surgery loads them: a stage-2 one of the
    same model whole (``ft_decoders_all`` re-initialises the heads only,
    not ``log_var``), a stage-1 one into a temporal model's ``depthcomp``,
    a temporal stage-2 one into the backbone of a stage-3 model whose
    backbone is temporal. A tree that the JAX package grafts and then
    fails on at its first step (its optimizer's tree no longer matches)
    is refused here at the graft: a temporal checkpoint into a stage-3
    backbone without the layer, or into a stage-2 model without it."""
    from creste_public_tpu_torch.models.distillation import (
        DistillationBackbone,
    )
    from creste_public_tpu_torch.models.lfd import MaxEntIRL
    from creste_public_tpu_torch.training.surgery import make_stage_loader
    from creste_public_tpu_torch.weights import init_weights

    cfg = temporal_cfg(use_pose=False)
    cfg["bev_classifier"]["net_kwargs"]["learnable_loss_weight"] = True
    trained = init_weights(TerrainNet(cfg), 12)
    with torch.no_grad():
        trained.bevclassifier.log_var.fill_(0.4)
    d2 = _save(trained, tmp_path / "s2" / "step_3")
    model, _, state = pipelines.init_stage("ssc", cfg, device="cpu")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    make_stage_loader("ssc", d2, "ft_decoders_all")(state)
    for k, v in model.state_dict().items():
        keep = "bevclassifier" in k and "head_" in k
        assert torch.equal(v, init[k] if keep else trained.state_dict()[k]), k
    assert float(model.bevclassifier.log_var.detach()) == pytest.approx(0.4)
    assert any(k.startswith("temporal_layer.") for k in init)

    stage1 = init_weights(DistillationBackbone(cfg), 11)
    d1 = _save(stage1, tmp_path / "s1" / "step_7")
    make_stage_loader("ssc", d1)(state)
    for k, v in stage1.state_dict().items():
        assert torch.equal(model.state_dict()[f"depthcomp.{k}"], v), k

    tcfg = copy.deepcopy(GROUPS["model"]["traversability/tiny"])
    tcfg["vision_backbone"] = copy.deepcopy(cfg)
    irl, _, istate = pipelines.init_stage("traversability", tcfg,
                                          device="cpu")
    make_stage_loader("traversability", d2)(istate)
    for k, v in trained.state_dict().items():
        assert torch.equal(irl.state_dict()[f"backbone.{k}"], v), k
    plain_t = copy.deepcopy(GROUPS["model"]["traversability/tiny"])
    _, _, pstate = pipelines.init_stage("traversability", plain_t,
                                        device="cpu")
    with pytest.raises(ValueError, match="does not graft"):
        make_stage_loader("traversability", d2)(pstate)
    plain_s = copy.deepcopy(GROUPS["model"]["ssc_sam/tiny"])
    _, _, sstate = pipelines.init_stage("ssc", plain_s, device="cpu")
    with pytest.raises(ValueError, match="does not graft"):
        make_stage_loader("ssc", d2)(sstate)
    assert isinstance(irl, MaxEntIRL)
