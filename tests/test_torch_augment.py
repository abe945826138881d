"""The port's augmentation and loader worker modes against the JAX
package's, bit for bit.

``data/augment.py`` is a numpy copy of the JAX package's: for the same
``np.random.Generator`` state every piece (colour jitter with its hue and
saturation round trip through HSV, gamma, the ``keep_aug`` reuse across
views, LiDAR dropout, the miscalibration warp, the depth noise) and the
whole ``augment_sample`` give equal arrays, and leave the generators in the
same state. The port's loader in process mode (a persistent spawn pool)
gives the batches of its thread mode, augmented, and both equal the JAX
loader's (tests/test_coda_dataset.py's test of the JAX loader).
"""
import numpy as np
import pytest

from creste_public_tpu.data import augment as jaug
from creste_public_tpu.data.dataloader import EpochLoader as JLoader
from creste_public_tpu.data.synthetic import SyntheticCodaDataset as JDataset
from creste_public_tpu_torch.data import augment as aug
from creste_public_tpu_torch.data.dataloader import EpochLoader, _sample_rng
from creste_public_tpu_torch.data.synthetic import SyntheticCodaDataset

CFG = {"image_size": [64, 80], "grid": 32, "map_range": 1.6, "fdn_dim": 16,
       "length": 6}


def _rgb(seed: int, shape=(48, 56, 3)) -> np.ndarray:
    rgb = np.random.default_rng(seed).uniform(size=shape).astype(np.float32)
    rgb[:4, :4] = 0.5  # grey: zero saturation, the HSV hue's d == 0 branch
    return rgb


def _depth(seed: int, shape=(48, 56)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    d = rng.uniform(300, 20000, size=shape).astype(np.float32)
    d[rng.uniform(size=shape) < 0.6] = 0.0  # sparse, as LiDAR depth is
    return d


def _same(ours, ref, g_ours, g_ref):
    np.testing.assert_array_equal(ours, ref)
    assert ours.dtype == ref.dtype
    # the generators advanced alike
    assert g_ours.bit_generator.state == g_ref.bit_generator.state


@pytest.mark.parametrize("piece", [
    "brightness_contrast", "saturation_hue", "gamma", "default"])
def test_colour_jitter_and_gamma_bit_equal(piece):
    kw = {"brightness_contrast": dict(saturation=0.0, hue=0.0, gamma=None),
          "saturation_hue": dict(brightness=0.0, contrast=0.0, gamma=None,
                                 saturation=0.5, hue=0.2),
          "gamma": dict(brightness=0.0, contrast=0.0, saturation=0.0,
                        hue=0.0, gamma=(0.5, 2.0), gamma_p=1.0),
          "default": {}}[piece]
    for seed in range(3):
        g1, g2 = np.random.default_rng(seed), np.random.default_rng(seed)
        rgb = _rgb(seed)
        ours = aug.ImageAugmentation(**kw)(rgb, g1)
        ref = jaug.ImageAugmentation(**kw)(rgb, g2)
        _same(ours, ref, g1, g2)
        assert not np.array_equal(ours, rgb)


def test_keep_aug_reuses_the_draw_across_views():
    g1, g2 = np.random.default_rng(5), np.random.default_rng(5)
    a, b = aug.ImageAugmentation(), jaug.ImageAugmentation()
    first = (a(_rgb(1), g1), b(_rgb(1), g2))
    second = (a(_rgb(2), g1, keep_aug=True), b(_rgb(2), g2, keep_aug=True))
    _same(*first, g1, g2)
    _same(*second, g1, g2)
    assert a._params == b._params


@pytest.mark.parametrize("piece", ["dropout", "miscalibration", "noise",
                                   "all"])
def test_depth_augmentation_bit_equal(piece):
    kw = {"dropout": dict(calib_error_std=(0.0, 0.0, 0.0),
                          depth_noise_std=0.0, dropout_prob=0.4),
          "miscalibration": dict(dropout_prob=0.0, depth_noise_std=0.0,
                                 calib_error_std=(3.0, 2.0, 0.05)),
          "noise": dict(dropout_prob=0.0, calib_error_std=(0.0, 0.0, 0.0),
                        depth_noise_std=0.5),
          "all": {}}[piece]
    for seed in range(3):
        g1, g2 = np.random.default_rng(seed), np.random.default_rng(seed)
        d = _depth(seed)
        ours = aug.DepthAugmentation(**kw)(d, g1)
        ref = jaug.DepthAugmentation(**kw)(d, g2)
        _same(ours, ref, g1, g2)
        assert not np.array_equal(ours, d)


def test_augment_sample_bit_equal():
    sample = SyntheticCodaDataset(cfg=CFG)[2]
    sample["image"] = np.concatenate([sample["image"]] * 3)  # three views
    for seed in range(2):
        g1, g2 = np.random.default_rng(seed), np.random.default_rng(seed)
        ours = aug.augment_sample(sample, g1)
        ref = jaug.augment_sample(dict(sample), g2)
        assert ours.keys() == ref.keys()
        for k in ours:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        assert g1.bit_generator.state == g2.bit_generator.state
        assert not np.array_equal(ours["image"], sample["image"])


def test_sample_rng_is_the_jax_loaders():
    from creste_public_tpu.data.dataloader import _sample_rng as j_sample_rng

    for args in [(0, 0, 0), (3, 1, 5), (7, 1001, 2)]:
        assert (_sample_rng(*args).bit_generator.state
                == j_sample_rng(*args).bit_generator.state)


def test_process_mode_equals_thread_mode_and_jax():
    kw = dict(batch_size=2, shuffle=True, seed=3, num_workers=2)
    thread = EpochLoader(SyntheticCodaDataset(cfg=CFG),
                         transform=aug.augment_sample, **kw)
    proc = EpochLoader(SyntheticCodaDataset(cfg=CFG),
                       transform=aug.augment_sample, worker_mode="process",
                       **kw)
    ref = list(JLoader(JDataset(cfg=CFG), transform=jaug.augment_sample,
                       **kw).epoch(1))
    try:
        a = list(thread.epoch(1))
        b = list(proc.epoch(1))
        assert len(a) == len(b) == len(ref) == 3
        for ba, bb, br in zip(a, b, ref):
            assert set(ba) == set(bb) == set(br)
            for k in ba:
                np.testing.assert_equal(ba[k], bb[k], err_msg=k)
                np.testing.assert_equal(ba[k], br[k], err_msg=k)
        # the pool is persistent: a second epoch reuses it
        pool = proc._pool
        assert sum(1 for _ in proc.epoch(2)) == 3 and proc._pool is pool
    finally:
        proc.close()
    assert proc._pool is None
    with pytest.raises(ValueError, match="worker_mode"):
        EpochLoader(SyntheticCodaDataset(cfg=CFG), 2, worker_mode="fork")
