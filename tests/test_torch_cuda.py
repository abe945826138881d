"""Tests of the port that need an NVIDIA GPU (marked ``gpu``; they skip
without one). This file imports no JAX, so on a machine without JAX it
runs on its own:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""
import pytest
import torch

from creste_public_tpu_torch import weights
from creste_public_tpu_torch.config import presets
from creste_public_tpu_torch.models.blocks.convnets import MultiScaleFCN
from creste_public_tpu_torch.ops import reward_kernel as rk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 64, 128, 40), (3, 32, 64, 40)])
def test_reward_kernel_matches_plain_on_card(cuda, shape):
    """The CUDA reward head against its plain version (cuDNN, TF32 off) on
    the card: rtol 1e-4, atol 1e-5, and seven launches per head."""
    cfg = presets.traversability_model_config()["traversability_head"][
        "net_kwargs"]["reward_cfg"]["net_kwargs"]
    m = weights.init_weights(MultiScaleFCN(cfg), 0).to(cuda)
    folded = rk.fold_msfcn_params(m)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0)).to(cuda)
    rk.conv_affine_cuda.launches = 0
    got = rk.msfcn_fused_apply(folded, x)
    torch.cuda.synchronize()
    assert rk.conv_affine_cuda.launches == 7
    torch.testing.assert_close(got, rk.msfcn_plain(folded, x), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.gpu
def test_reward_kernel_rejects_bad_input(cuda):
    ly = {"kernel": torch.zeros(3, 3, 4, 2, device=cuda),
          "a": torch.ones(2, device=cuda), "b": torch.zeros(2, device=cuda),
          "pre_relu": False, "post_relu": True}
    with pytest.raises(ValueError, match="contiguous"):
        rk.conv_affine_cuda(torch.zeros(1, 4, 5, 6, device=cuda)[..., :4], ly)
    with pytest.raises(ValueError, match="float32"):
        rk.conv_affine_cuda(torch.zeros(1, 4, 5, 4, device=cuda,
                                        dtype=torch.float16), ly)
