"""The port's PE-free multiview stage 1 (``presets.tiny_pefree_config``:
the learnable PE map, the max-mode multiview splat and ``PEFreeMSELoss``)
trained against the JAX package's ``pipelines.make_train_step
("distillation")`` on the CPU: the model in eval and train mode, three
chained training steps.

Setup: ``tiny_pefree_config`` (V=2 views) with ``stage_repeats=2`` (5
residual blocks, so drop-connect fires over the B*V frames), three B=2
multiview batches made as the JAX package's
``tests/test_pefree_multiview.py::make_batch`` (seeded 0, 1, 2; the
synthetic dataset has one view, so this preset has no CLI dataset),
seeded flax-shaped weights with jittered BatchNorms and the PE map at
0.05 N, masks fed to both sides (``tests/test_torch_step_helpers.py``
says how and derives the step tolerances).

Tolerances: the model's outputs to FORWARD_RTOL of their largest entry (the
trunk's f32 sums, then a max splat of features that differ by that much:
``bev_features`` reads ~2e-5); the step as the helpers state (METRIC_RTOL
1e-4, gradients by module in f32 to 5e-2 and per tensor in f64 to 1e-5).
"""
import pytest

from creste_public_tpu_torch.config import presets
from tests.test_torch_step_helpers import (
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    STEPS,
    check_chained_steps,
    check_f64_gradient,
    check_forward_matches_flax,
    check_step_from_jax_state,
    jax_stage_run,
    make_masks,
    multiview_batch,
)

FORWARD_RTOL = 1e-3
N_MASKS = 5  # residual blocks of the b0 trunk at stage_repeats=2


@pytest.fixture(scope="module")
def pefree_run():
    cfg = presets.tiny_pefree_config().to_dict()
    cfg["vision_backbone"]["effnet_cfgs"]["stage_repeats"] = 2
    batches = [multiview_batch(seed=t) for t in range(STEPS)]
    return jax_stage_run("distillation", cfg, batches,
                         make_masks(N_MASKS, 4))


@pytest.mark.parametrize("train", [False, True])
def test_pefree_model_matches_flax(pefree_run, train):
    model = check_forward_matches_flax(pefree_run, train, FORWARD_RTOL)
    assert model.cam2map is not None


@pytest.mark.parametrize("t", range(STEPS))
def test_pefree_step_from_jax_state(pefree_run, t):
    check_step_from_jax_state(pefree_run, t)


def test_pefree_f64_gradient_matches_jax(pefree_run):
    check_f64_gradient(pefree_run)


def test_pefree_three_chained_steps(pefree_run):
    check_chained_steps(pefree_run)
