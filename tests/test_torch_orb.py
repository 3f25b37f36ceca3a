"""Port parity: ORB extraction (ops/orb.py) against the JAX extractor in its
Pallas front-end configuration (kernels in interpret mode on the CPU).

- the static tables are the same arrays, bit for bit;
- level 0 (no resize) gives identical keypoints; the other levels come
  from a bilinear resize that differs from jax.image.resize by ~3e-5, so
  >= 98% of all valid slots must be identical;
- on identical keypoints the angle is within 1e-3 rad and a descriptor
  has <= 4 flipped bits (f32 rounding of the blur can flip a near-tie);
- K2 for all levels at once before the level loop gives the same features,
  bit for bit, as the one-level K2 inside the loop, level by level.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioncheck_ccm_slam_tpu.config import DEFAULT_CONFIG
from motioncheck_ccm_slam_tpu.ops import fast_pallas, orb as jorb
from motioncheck_ccm_slam_tpu_torch import convert
from motioncheck_ccm_slam_tpu_torch.ops import fast_cuda, image as image_ops, orb as torb

import torch_one_thread  # noqa: F401 (torch on one thread)


def test_static_tables_bitwise():
    np.testing.assert_array_equal(torb._brief_pattern(), jorb._brief_pattern())
    for a, b in zip(torb._ic_moment_factors(15), jorb._ic_moment_factors(15)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(torb._ic_angle_mask(15), jorb._ic_angle_mask(15)):
        np.testing.assert_array_equal(a, b)
    p = DEFAULT_CONFIG.extractor
    assert torb.level_feature_budgets(1024, 8, 1.2) == jorb.level_feature_budgets(1024, 8, 1.2)
    np.testing.assert_array_equal(torb.scale_factors(p), jorb.scale_factors(p))
    np.testing.assert_array_equal(torb.inv_level_sigma2(p), jorb.inv_level_sigma2(p))


def test_top_k_tie_order_matches_lax_top_k():
    x = np.array([0, 3, 1, 3, 0, 3, 2, 0, 0, 3], np.float32)
    _, ji = jax.lax.top_k(jnp.asarray(x), 5)
    _, ti = torb._top_k(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.fixture(scope="module")
def extracted():
    """Both extractors on the 137x201 fixture of tests/test_fast_pallas.py
    with a 150-feature budget (the smallest levels cannot fill 1000)."""
    rng = np.random.default_rng(42)
    img = rng.uniform(0, 64, (137, 201)).astype(np.float32)
    for y, x in rng.integers(25, 110, (30, 2)):
        img[y:y + 3, x:x + 3] += 150.0
    params = dataclasses.replace(DEFAULT_CONFIG.extractor, max_features=150)
    prev = jorb.FAST_BACKEND, fast_pallas.FORCE_INTERPRET
    try:
        jorb.FAST_BACKEND, fast_pallas.FORCE_INTERPRET = "pallas", True
        # a fresh jit traces with the Pallas front-end (and compiles faster
        # than eager dispatch of the 8 levels)
        ref = jax.jit(lambda im: jorb.extract_orb(im, params))(jnp.asarray(img))
    finally:
        jorb.FAST_BACKEND, fast_pallas.FORCE_INTERPRET = prev
    out = convert.orb_features_to_numpy(torb.extract_orb(torch.from_numpy(img), params))
    ref = jorb.OrbFeatures(*(np.asarray(a) for a in ref))
    return ref, out


def test_extract_orb_level0_identical(extracted):
    ref, out = extracted
    l0 = ref.octave == 0
    assert l0.sum() > 0 and ref.valid[l0].sum() > 20
    np.testing.assert_array_equal(out.valid[l0], ref.valid[l0])
    np.testing.assert_array_equal(out.octave, ref.octave)
    v = ref.valid & l0
    np.testing.assert_array_equal(out.xy[v], ref.xy[v])
    np.testing.assert_array_equal(out.response[v], ref.response[v])


def test_extract_orb_all_levels_close(extracted):
    ref, out = extracted
    assert out.desc.dtype == np.uint32 and out.desc.shape == ref.desc.shape
    v_any = ref.valid | out.valid
    same = (ref.valid == out.valid) & np.all(ref.xy == out.xy, -1)
    assert same[v_any].mean() >= 0.98, same[v_any].mean()
    s = same & ref.valid
    da = np.abs(out.angle[s] - ref.angle[s])
    da = np.minimum(da, 2 * np.pi - da)
    assert da.max() < 1e-3
    flipped = np.unpackbits((out.desc[s] ^ ref.desc[s]).view(np.uint8), axis=-1).sum(-1)
    assert flipped.max() <= 4, f"max hamming drift {flipped.max()}"


def _extract_orb_level_by_level(img, params):
    """extract_orb with the one-level K1 and K2 called inside the level
    loop, on each level in turn, as the loop ran before K1 and K2 took all
    levels in one launch each."""
    levels = image_ops.build_pyramid(img, params.n_levels, params.scale_factor)
    budgets = torb.level_feature_budgets(params.max_features, params.n_levels,
                                         params.scale_factor)
    parts = []
    for l, (lvl_img, k_level) in enumerate(zip(levels, budgets)):
        lvl_img = lvl_img.contiguous()
        score_map = fast_cuda.masked_corner_score(lvl_img, **torb.corner_score_kwargs(params))
        xy, score, valid = torb._select_level_keypoints(score_map, k_level)
        blur, m10, m01 = fast_cuda.blur_and_moments(lvl_img, half_patch=params.half_patch_size)
        ang = torb.ic_angles(lvl_img, xy, (m10, m01))
        parts.append((xy * params.scale_factor ** l, score, ang,
                      torch.full((k_level,), l, dtype=torch.int64),
                      torb.brief_descriptors(blur, xy, ang), valid))
    return torb.OrbFeatures(*(torch.cat(f) for f in zip(*parts)))


def test_extract_orb_same_as_level_by_level():
    rng = np.random.default_rng(42)
    img = rng.uniform(0, 64, (137, 201)).astype(np.float32)
    for y, x in rng.integers(25, 110, (30, 2)):
        img[y:y + 3, x:x + 3] += 150.0
    params = dataclasses.replace(DEFAULT_CONFIG.extractor, max_features=150)
    out = torb.extract_orb(torch.from_numpy(img), params)
    want = _extract_orb_level_by_level(torch.from_numpy(img), params)
    assert int(want.valid.sum()) > 50
    for name, a, b in zip(torb.OrbFeatures._fields, out, want):
        assert torch.equal(a, b), name
