"""The port's folded reward head (ops/reward_kernel.py) against the JAX
package: the Pallas kernel in interpret mode and the flax MultiScaleFCN.

On the CPU the head runs its plain PyTorch version; the CUDA kernel is held
against that version on the card by chip_smoke.py. Tolerance: rtol 1e-4,
atol 1e-5 (f32; the BN fold reassociates the affine and sums run in another
order), as the JAX package's own fused-head test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creste_public_tpu.config import presets as jpresets
from creste_public_tpu.models.blocks.convnets import MultiScaleFCN as JFCN
from creste_public_tpu.ops.reward_pallas import msfcn_fused_apply as jfused
from creste_public_tpu_torch.models.blocks.convnets import MultiScaleFCN
from creste_public_tpu_torch.ops import _build
from creste_public_tpu_torch.ops import reward_kernel as rk
from creste_public_tpu_torch.weights import load_jax_variables
from tests.test_torch_helpers import flat_variables, jax_variables, jitter_bn

RTOL, ATOL = 1e-4, 1e-5


def _head_cfg():
    cfg = jpresets.traversability_model_config().to_dict()
    return cfg["traversability_head"]["net_kwargs"]["reward_cfg"]["net_kwargs"]


@pytest.mark.parametrize("shape", [(1, 64, 128, 40), (3, 32, 64, 40)])
def test_fused_head_matches_pallas_and_flax(shape):
    cfg = _head_cfg()
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    jm = JFCN(cfg)
    flat = jitter_bn(flat_variables(
        jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))))
    jv = jax_variables(flat)
    ref_flax = np.asarray(jm.apply(jv, jnp.asarray(x), False))
    ref_pallas = np.asarray(jfused(jv, jnp.asarray(x), interpret=True))

    m = load_jax_variables(MultiScaleFCN(cfg), flat).eval()
    folded = rk.fold_msfcn_params(m)
    rk.conv_affine_cuda.launches = 0
    got = rk.msfcn_fused_apply(folded, torch.from_numpy(x)).numpy()
    assert rk.conv_affine_cuda.launches == 0  # CPU tensors: plain version
    assert got.shape == ref_flax.shape == shape[:3] + (1,)
    np.testing.assert_allclose(got, ref_pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref_flax, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        rk.msfcn_plain(folded, torch.from_numpy(x)).numpy(), got, rtol=0,
        atol=0)


def test_fold_matches_jax_fold():
    """Per-layer (kernel, a, b, pre_relu) equal the JAX package's fold."""
    from creste_public_tpu.ops.reward_pallas import fold_msfcn_params

    cfg = _head_cfg()
    jm = JFCN(cfg)
    flat = jitter_bn(flat_variables(jm.init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 8, 8, 40)))))
    jv = jax_variables(flat)
    jf = fold_msfcn_params(jv["params"], jv["batch_stats"])
    tf = rk.fold_msfcn_params(
        load_jax_variables(MultiScaleFCN(cfg), flat).eval())
    assert [len(tf[k]) for k in jf] == [2, 2, 2, 1]
    for k in jf:
        for j, t in zip(jf[k], tf[k]):
            np.testing.assert_array_equal(t["kernel"].numpy(),
                                          np.asarray(j["kernel"]))
            np.testing.assert_allclose(t["a"].numpy(), np.asarray(j["ab"][0]),
                                       rtol=1e-6)
            np.testing.assert_allclose(t["b"].numpy(), np.asarray(j["ab"][1]),
                                       rtol=1e-6, atol=1e-7)
            assert t["pre_relu"] == j["pre_relu"] and t["post_relu"]


def _layer(ci=4, co=3, k=3):
    g = torch.Generator().manual_seed(0)
    return {"kernel": torch.randn(k, k, ci, co, generator=g),
            "a": torch.rand(co, generator=g), "b": torch.randn(co, generator=g),
            "pre_relu": True, "post_relu": True}


def test_plain_layer_matches_direct_sum():
    """conv_affine_plain == the tap-by-tap sum the kernel computes."""
    ly = _layer()
    x = torch.randn(2, 5, 6, 4, generator=torch.Generator().manual_seed(1))
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    acc = sum(xp[:, dy:dy + 5, dx:dx + 6, :] @ ly["kernel"][dy, dx]
              for dy in range(3) for dx in range(3))
    want = torch.relu(torch.relu(acc) * ly["a"] + ly["b"])
    torch.testing.assert_close(rk.conv_affine(x, ly), want, rtol=1e-5,
                               atol=1e-5)


def test_cuda_wrapper_refuses_non_cuda_tensors():
    ly = _layer()
    rk.conv_affine_cuda.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        rk.conv_affine_cuda(torch.zeros(1, 5, 6, 4), ly)
    meta = torch.zeros(1, 5, 6, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rk.conv_affine(meta, ly)  # not CPU: never the plain version
    rk.conv_affine(torch.zeros(1, 5, 6, 4), ly)
    assert rk.conv_affine_cuda.launches == 0


def test_kernel_build_needs_nvcc(monkeypatch):
    """Without nvcc the build raises; it never falls back to the plain
    version."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    if any(_build.library_path(n).exists() for n in _build.sources()):
        pytest.skip("a built kernel library is present")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert _build.sources() == ["msfcn_chain", "svf", "value_iteration"]
