"""The port's reference-checkpoint importer (``training.torch_import``)
against the JAX package's (``creste_public_tpu/training/torch_import.py``),
on the CPU at the tiny presets of every stage.

A seeded flax-shaped tree with jittered BatchNorms goes through the JAX
package's ``export_torch_style`` (reference key names, reference tensor
layouts); the port's import of it must equal ``weights.
from_jax_variables`` of the same tree bit for bit, key for key, and the
port's ``export_reference_style`` must give back the JAX export bit for
bit. The port is OIHW like the reference, so no tolerance applies: every
comparison is exact.
"""
import numpy as np
import pytest
import torch

from creste_public_tpu.config import presets as jpresets
from creste_public_tpu.training import pipelines as jpipelines
from creste_public_tpu.training.torch_import import (
    convert_torch_state_dict,
    export_torch_style,
)
from creste_public_tpu_torch.config import presets
from creste_public_tpu_torch.training import pipelines
from creste_public_tpu_torch.training.torch_import import (
    export_reference_style,
    import_reference_state_dict,
    merge_into_state,
)
from creste_public_tpu_torch.weights import from_jax_variables
from tests.test_torch_helpers import jax_variables, jitter_bn, seeded_variables

STAGES = {
    "depth": "tiny_depth_config",
    "distillation": "tiny_pefree_config",
    "ssc": "tiny_terrainnet_config",
    "traversability": "tiny_traversability_config",
}


@pytest.fixture(scope="module", params=list(STAGES))
def case(request):
    """(stage, the flat seeded tree, the JAX reference-style export); the
    stage-3 model without the MDP solve (the deployment graph)."""
    stage = request.param
    cfg = dict(getattr(jpresets, STAGES[stage])().to_dict(),
               solve_mdp=False)
    rng = np.random.default_rng(0)
    rgbd = rng.uniform(0, 1, (1, 1, 64, 80, 4)).astype(np.float32)
    rgbd[..., 3] *= 3000.0
    p2p = np.tile(np.eye(4, dtype=np.float32), (1, 1, 1, 1))
    flat = jitter_bn(seeded_variables(jpipelines.build_model(stage, cfg),
                                      rgbd, p2p, seed=3))
    return stage, flat, export_torch_style(jax_variables(flat))


def test_import_equals_from_jax_variables(case):
    """Every reference key is taken (none unmatched), and the imported
    state equals ``from_jax_variables`` of the same tree, key for key and
    bit for bit; it loads strictly into the port's model."""
    stage, flat, ref = case
    state, unmatched = import_reference_state_dict(ref)
    assert unmatched == []
    want = from_jax_variables(flat)
    assert state.keys() == want.keys()
    for k in want:
        assert state[k].dtype == want[k].dtype, k
        assert torch.equal(state[k], want[k]), k
    model = pipelines.build_model(stage, dict(
        getattr(presets, STAGES[stage])().to_dict(), solve_mdp=False))
    model.load_state_dict(state, strict=True)


def test_export_reference_style_round_trip(case):
    """The port's export of ``from_jax_variables(flat)`` equals the JAX
    package's ``export_torch_style`` of the tree, key for key and bit for
    bit; importing it gives the state back exactly; and the JAX package's
    own importer takes every key of the port's export."""
    _, flat, ref = case
    state = from_jax_variables(flat)
    back = export_reference_style(state)
    assert back.keys() == ref.keys()
    for k, v in ref.items():
        assert np.array_equal(back[k].numpy(), np.asarray(v)), k
    again, unmatched = import_reference_state_dict(back)
    assert unmatched == []
    assert all(torch.equal(again[k], state[k]) for k in state)
    _, _, jax_unmatched = convert_torch_state_dict(
        {k: v.numpy() for k, v in back.items()})
    assert jax_unmatched == []


def test_reference_names(case):
    """The reference's own names appear in the export as
    ``tests/test_torch_import.py`` expects them: the trunk's
    ``_blocks.N._depthwise_conv``, torchvision's ``downsample.0``, the
    reward net's ``prepool.0.conv`` / ``trunk.1.conv`` / ``trunk.2``
    running statistics, the PE map and its head, the fusion's ``convs``."""
    stage, _, ref = case
    keys = list(ref)
    assert all(k.startswith("model.") for k in keys)
    assert any("._blocks.0._depthwise_conv.weight" in k for k in keys)
    if stage in ("ssc", "traversability"):
        assert any("bevclassifier.layer2.0.downsample.0.weight" in k
                   for k in keys)
        assert any("vision_fusion.convs.0.weight" in k for k in keys)
    if stage == "traversability":
        for frag in (".r.prepool.0.conv.weight", ".r.trunk.1.conv.weight",
                     ".r.trunk.2.running_mean"):
            assert any(frag in k for k in keys), frag
    if stage == "distillation":
        assert any(k.endswith("learnable_pe_map") for k in keys)
        assert any(".pe_head.0.weight" in k for k in keys)


def test_pe_map_and_reward_head_values():
    """The PE map keeps its NCHW layout and the reward net's trunk
    interleaving (conv at 1 + 3i, bare BN at 2 + 3i) maps to
    ``trunk_i.Conv_0`` / ``trunk_bn_i``, value for value."""
    sd = {
        "model.depthcomp.learnable_pe_map": torch.arange(24.).reshape(
            1, 2, 3, 4),
        "model.traversability_head.r.trunk.1.conv.weight": torch.ones(
            2, 2, 3, 3),
        "model.traversability_head.r.trunk.2.running_var": torch.full(
            (2,), 2.0),
        "model.traversability_head.r.trunk.4.conv.weight": torch.zeros(
            2, 2, 1, 1),
    }
    state, unmatched = import_reference_state_dict(sd)
    assert unmatched == []
    assert torch.equal(state["depthcomp.learnable_pe_map"],
                       sd["model.depthcomp.learnable_pe_map"])
    assert set(state) == {
        "depthcomp.learnable_pe_map",
        "traversability_head.r.trunk_0.Conv_0.weight",
        "traversability_head.r.trunk_bn_0.running_var",
        "traversability_head.r.trunk_1.Conv_0.weight"}


def test_sequential_without_batch_norm():
    """A MultiLayerConv Sequential without BatchNorms (conv / ReLU, period
    2) maps index 2 to the second conv, as the JAX importer reads it; with
    BatchNorms (period 3) index 3 is the second conv and 1 its BN."""
    plain = {"model.dino_head.model.0.weight": torch.ones(4, 4, 1, 1),
             "model.dino_head.model.2.weight": torch.ones(4, 4, 1, 1)}
    state, _ = import_reference_state_dict(plain)
    assert set(state) == {"dino_head.Conv_0.weight",
                          "dino_head.Conv_1.weight"}
    assert set(export_reference_style(state)) == set(plain)
    normed = {"model.dino_head.model.0.weight": torch.ones(4, 4, 1, 1),
              "model.dino_head.model.1.running_mean": torch.zeros(4),
              "model.dino_head.model.3.weight": torch.ones(4, 4, 1, 1)}
    state, _ = import_reference_state_dict(normed)
    assert set(state) == {"dino_head.Conv_0.weight",
                          "dino_head.BatchNorm_0.running_mean",
                          "dino_head.Conv_1.weight"}


def test_unmatched_reported_and_ignored_keys_dropped():
    """An unknown key is reported as it was given; ``num_batches_tracked``
    and the trunk's classification tail are dropped without a report."""
    sd = {"model.some_unknown_module.weight": np.zeros((3, 3)),
          "model.backbone.bevclassifier.bn1.num_batches_tracked":
              np.zeros(()),
          "model.backbone.depthcomp.depthcomp.vision_backbone.model.trunk."
          "_fc.weight": np.zeros((2, 2))}
    state, unmatched = import_reference_state_dict(sd)
    assert state == {}
    assert unmatched == ["model.some_unknown_module.weight"]


def test_shape_mismatch_raises(case):
    """A reference tensor of another shape than the port's raises; a key
    the port lacks raises only with ``require_match``."""
    _, flat, ref = case
    target = from_jax_variables(flat)
    state, _ = import_reference_state_dict(ref)
    key = next(k for k in state if k.endswith("conv_stem.weight"))
    bad = dict(state)
    bad[key] = torch.zeros(32, 5, 3, 3)
    with pytest.raises(ValueError, match="Shape mismatch"):
        merge_into_state(target, bad)
    extra = dict(state, **{"nowhere.weight": torch.zeros(1)})
    with pytest.raises(KeyError):
        merge_into_state(target, extra)
    merged = merge_into_state(target, extra, require_match=False)
    assert merged.keys() == target.keys()
