"""The port's stage-3 forward, ``MaxEntIRL(solve_mdp=True)`` in eval mode,
against the flax ``MaxEntIRL.apply(train=False)`` at the tiny preset on the
CPU: the ``pp`` rollout (sharpened SVF + greedy rollout), the ``fc``
rollout, and the gaussian and dot goals.

The expert poses, image and p2p come from the JAX package's synthetic
dataset; the weights are a seeded flax-shaped tree with jittered BNs,
carried into the port by ``from_jax_variables``. Tolerances: the reward and
its input view rtol/atol 1e-3, the other backbone maps 1e-3 of their scale
(the bars of tests/test_torch_main_path.py); V and Q 5e-3 (the reward's
end-to-end difference, ~1e-4, grows by up to 1/(1 - gamma) in the solve);
the policy, the expected SVF and the fc policy 1e-3; the goal 1e-6; the
integer rollout states exactly.
"""
import numpy as np
import pytest
import torch

from creste_public_tpu.config import presets as jpresets
from creste_public_tpu.data.synthetic import SyntheticCodaDataset, collate
from creste_public_tpu.models.lfd import MaxEntIRL as JMaxEntIRL
from creste_public_tpu_torch.models.lfd import MaxEntIRL
from creste_public_tpu_torch.ops.svf_kernel import expected_svf_cuda
from creste_public_tpu_torch.ops.vi_kernel import value_iteration_cuda
from creste_public_tpu_torch.weights import from_jax_variables
from tests.test_torch_helpers import jax_variables, jitter_bn, seeded_variables

TOL = {"value_estimate": 5e-3, "q_estimate": 5e-3, "policy": 1e-3,
       "exp_svf": 1e-3, "policy_fc": 1e-3, "goal": 1e-6,
       "traversability_preds": 1e-3, "traversability_preds_full": 1e-3,
       "input_view": 1e-3}
EXACT = ("state_preds", "state_preds_grid")


@pytest.fixture(scope="module")
def tiny():
    cfg = jpresets.tiny_traversability_config().to_dict()
    h, w = cfg["vision_backbone"]["vision_backbone"]["effnet_cfgs"][
        "image_size"]
    ds = SyntheticCodaDataset(image_size=(h, w), grid=32, map_range=1.6,
                              fdn_dim=16, horizon=cfg["action_horizon"],
                              length=2)
    batch = collate([ds[0], ds[1]])
    args = (batch["image"], batch["p2p"])
    flat = jitter_bn(seeded_variables(
        JMaxEntIRL(dict(cfg, solve_mdp=False)), *args))
    return cfg, batch, flat


def _run(cfg, batch, flat):
    args = (batch["image"], batch["p2p"], batch["traversability_label"])
    ref = JMaxEntIRL(cfg).apply(jax_variables(flat), *args, False)
    m = MaxEntIRL(cfg)
    m.load_state_dict(from_jax_variables(flat), strict=True)
    value_iteration_cuda.launches = expected_svf_cuda.launches = 0
    with torch.no_grad():
        out = m.eval()(*(torch.from_numpy(a) for a in args))
    assert value_iteration_cuda.launches == expected_svf_cuda.launches == 0
    assert sorted(out) == sorted(ref)
    for k, v in ref.items():
        got, want = out[k].numpy(), np.asarray(v)
        assert got.shape == want.shape, k
        if k in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=k)
        elif k in TOL:
            np.testing.assert_allclose(got, want, rtol=TOL[k], atol=TOL[k],
                                       err_msg=k)
        else:  # the backbone's maps: max|d| / max(1, max|ref|)
            scale = max(1.0, float(np.abs(want).max()))
            assert np.abs(got - want).max() <= 1e-3 * scale, k
    return out


@pytest.mark.parametrize("method,goal", [("pp", None), ("fc", None),
                                         ("pp", "gaussian"), ("pp", "dot")])
def test_mdp_path_matches_flax(tiny, method, goal):
    cfg, batch, flat = tiny
    cfg = dict(cfg, policy_method=method)
    if goal:
        cfg["goal_kwargs"] = {"method": goal}
    if method == "fc":
        flat = dict(flat)
        flat["params/fc/kernel"] = np.random.default_rng(5).normal(
            size=(8, 8)).astype(np.float32)
    out = _run(cfg, batch, flat)
    B, T = 2, cfg["action_horizon"]
    assert out["policy"].shape == (B, 8, 16, 8)
    assert out["state_preds"].shape == (B, T, 2)
    np.testing.assert_allclose(out["policy"].sum(-1).numpy(), 1.0, atol=1e-5)
    if method == "pp":
        mass = out["exp_svf"].sum((1, 2))
        assert ((mass > 0) & (mass <= T + 1e-4)).all()
        assert (out["state_preds_grid"].sum((1, 2)) == T).all()
    else:
        assert out["policy_fc"].shape == (B, T, 8)
        assert not out["policy_fc"][:, 0].any()
    if goal:
        assert out["goal"].shape == (B, 16, 32, 1)
