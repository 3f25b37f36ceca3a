"""Port parity: the plain versions of K1 and K2 (ops/fast_cuda.py in the
torch port) against the Pallas kernels of ops/fast_pallas.py, run in
interpret mode on the CPU, on identical level images.

K1 is held bitwise (same f32 adds in the same ring order, pad region zero).
K2 is held to the bounds the JAX package holds its own kernel to
(tests/test_fast_pallas.py): blur atol 1e-3, moments atol 1.0 (f32
reassociation over 18 channels x 31 taps of values up to ~1e5). K2's
all-levels wrapper, blur_and_moments_levels, runs the plain version on each
level of a CPU pyramid, and so does K1's, masked_corner_score_levels: each
of its levels is held bitwise to the Pallas kernel and to the one-level
plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioncheck_ccm_slam_tpu.config import DEFAULT_CONFIG
from motioncheck_ccm_slam_tpu.ops import fast_pallas
from motioncheck_ccm_slam_tpu_torch.ops import fast_cuda, image as image_ops

import torch_one_thread  # noqa: F401 (torch on one thread)


def _fixture_137x201():
    # the fixture of tests/test_fast_pallas.py
    rng = np.random.default_rng(42)
    base = rng.uniform(0, 64, (137, 201)).astype(np.float32)
    for y, x in rng.integers(25, 110, (30, 2)):
        base[y:y + 3, x:x + 3] += 150.0
    return base


def _blobs(h, w, seed):
    """Textured image with bright/dark squares: both thresholds fire."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(60, 120, (h, w)).astype(np.float32)
    for y, x in rng.integers(0, (h - 3, w - 3), (h * w // 400, 2)):
        img[y:y + 3, x:x + 3] = rng.choice([10.0, 240.0])
    return img


IMAGES = {
    "fixture_137x201": _fixture_137x201,
    "blobs_96x130": lambda: _blobs(96, 130, 1),
    "blobs_161x252": lambda: _blobs(161, 252, 2),   # level 6 of 752x480
}


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_masked_corner_score_plain_bitwise(name):
    img = IMAGES[name]()
    p = DEFAULT_CONFIG.extractor
    kw = dict(th_hi=float(p.ini_th_fast), th_lo=float(p.min_th_fast),
              border=p.edge_threshold)
    ref = np.asarray(fast_pallas.masked_corner_score(
        jnp.asarray(img), interpret=True, **kw))
    out = fast_cuda.masked_corner_score_ref(torch.from_numpy(img), **kw).numpy()
    assert out.shape == ref.shape == fast_cuda.padded_shape(*img.shape)
    assert (out > 0).sum() > 50, "image produced too few corners"
    np.testing.assert_array_equal(out, ref)
    h, w = img.shape
    assert np.abs(out[h:]).sum() == 0.0 and np.abs(out[:, w:]).sum() == 0.0


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_blur_and_moments_plain_close(name):
    img = IMAGES[name]()
    h, w = img.shape
    ref = fast_pallas.blur_and_moments(jnp.asarray(img), half_patch=15,
                                       interpret=True)
    out = fast_cuda.blur_and_moments_ref(torch.from_numpy(img), half_patch=15)
    for o, r, atol in zip(out, ref, (1e-3, 1.0, 1.0)):
        assert tuple(o.shape) == fast_cuda.padded_shape(h, w)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=atol)


def test_blur_and_moments_levels_plain_per_level_and_pallas():
    """blur_and_moments_levels on a 3-level pyramid: each level's maps equal
    blur_and_moments_ref on that level, and level 1's are within the
    tolerance of the Pallas kernel in interpret mode (level 1 is 96x130,
    a shape the Pallas test above has compiled already)."""
    img = torch.from_numpy(_blobs(115, 156, 3))
    levels = [lv.contiguous() for lv in image_ops.build_pyramid(img, 3, 1.2)]
    assert tuple(levels[1].shape) == (96, 130)
    out = fast_cuda.blur_and_moments_levels(levels, half_patch=15)
    assert len(out) == 3
    for maps, lv in zip(out, levels):
        for o, r in zip(maps, fast_cuda.blur_and_moments_ref(lv, half_patch=15)):
            assert tuple(o.shape) == fast_cuda.padded_shape(*lv.shape)
            assert torch.equal(o, r)
    ref = fast_pallas.blur_and_moments(jnp.asarray(levels[1].numpy()), half_patch=15,
                                       interpret=True)
    for o, r, atol in zip(out[1], ref, (1e-3, 1.0, 1.0)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=atol)


def _k1_level_sets():
    """name -> levels: the 8-level pyramid (DEFAULT_CONFIG's scale) of a
    reduced 150x200 frame, whose top levels hold only a few pixels inside
    the border, and IMAGES' odd shapes as the levels of one call."""
    p = DEFAULT_CONFIG.extractor
    frame = torch.from_numpy(_blobs(150, 200, 5))
    return {
        "pyramid_150x200": [lv.contiguous() for lv in
                            image_ops.build_pyramid(frame, p.n_levels, p.scale_factor)],
        "odd_shapes": [torch.from_numpy(IMAGES[n]()) for n in sorted(IMAGES)],
    }


@pytest.mark.parametrize("case", ["pyramid_150x200", "odd_shapes"])
def test_masked_corner_score_levels_plain_bitwise(case):
    p = DEFAULT_CONFIG.extractor
    kw = dict(th_hi=float(p.ini_th_fast), th_lo=float(p.min_th_fast),
              border=p.edge_threshold)
    levels = _k1_level_sets()[case]
    out = fast_cuda.masked_corner_score_levels(levels, **kw)
    assert len(out) == len(levels)
    assert sum(int((o > 0).sum()) for o in out) > 50, "too few corners"
    for o, lv in zip(out, levels):
        assert tuple(o.shape) == fast_cuda.padded_shape(*lv.shape)
        assert torch.equal(o, fast_cuda.masked_corner_score_ref(lv, **kw))
        ref = np.asarray(fast_pallas.masked_corner_score(jnp.asarray(lv.numpy()),
                                                         interpret=True, **kw))
        np.testing.assert_array_equal(o.numpy(), ref)
