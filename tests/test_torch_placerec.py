"""Port parity: place recognition (models/vocabulary.py and
models/database.py) against the JAX package on the same inputs.

- ``default_vocabulary``'s centroids and idf are bitwise equal (the port
  keeps a copy of the numpy training code);
- ``make_transform``: the words are equal and the BoW within 1e-6, on
  tests/test_vocabulary.py's descriptors and on descriptors one to eight
  bits away from a training sample;
- ``KeyFrameDatabase``: the scores within 1e-6, and the loop and
  map-match candidates equal, on tests/test_vocabulary.py's inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioncheck_ccm_slam_tpu.models import vocabulary as jvoc
from motioncheck_ccm_slam_tpu.models.database import KeyFrameDatabase as JDatabase
from motioncheck_ccm_slam_tpu_torch import convert
from motioncheck_ccm_slam_tpu_torch.models import vocabulary as tvoc
from motioncheck_ccm_slam_tpu_torch.models.database import KeyFrameDatabase as TDatabase

from test_vocabulary import perturb, rand_desc
import torch_one_thread  # noqa: F401 (torch on one thread)

BOW_ATOL = 1e-6
# the vocabularies of tests/test_vocabulary.py and the system's default
VOCABS = [dict(k=4, levels=3, n_train=4000), dict(k=8, levels=4, n_train=8000), dict()]


def _vocabs(kw):
    return jvoc.default_vocabulary(**kw), tvoc.default_vocabulary(**kw)


def _t(desc):
    return convert.desc_from_numpy(desc, "cpu")


@pytest.mark.parametrize("kw", VOCABS, ids=["k4_l3", "k8_l4_8000", "default"])
def test_default_vocabulary_is_bitwise_equal(kw):
    vj, vt = _vocabs(kw)
    assert (vt.k, vt.levels, vt.n_words) == (vj.k, vj.levels, vj.n_words)
    assert len(vt.centroids) == len(vj.centroids)
    for cj, ct in zip(vj.centroids, vt.centroids):
        assert ct.dtype == cj.dtype and (ct == cj).all()
    assert vt.idf.dtype == vj.idf.dtype and (vt.idf == vj.idf).all()


@pytest.mark.parametrize("kw", VOCABS, ids=["k4_l3", "k8_l4_8000", "default"])
@pytest.mark.parametrize("source", ["random", "near_training"])
def test_transform_matches_jax(kw, source):
    vj, vt = _vocabs(kw)
    rng = np.random.default_rng(5)
    if source == "random":
        d = rand_desc(rng, 256)
    else:   # close to the tree's own centroids: ties and near-ties at each level
        leaves = vj.centroids[-1][rng.integers(0, vj.n_words, 256)]
        d = np.stack([perturb(rng, leaves[i:i + 1], int(rng.integers(1, 9)))[0]
                      for i in range(256)])
    valid = rng.random(256) < 0.9
    w_j, b_j = jvoc.make_transform(vj)(jnp.asarray(d), jnp.asarray(valid))
    w_t, b_t = tvoc.make_transform(vt, "cpu")(_t(d), torch.from_numpy(valid))
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=0, atol=BOW_ATOL)
    assert abs(float(b_t.abs().sum()) - 1.0) < 1e-5
    s_j = float(jvoc.bow_score(b_j, b_j[::-1]))
    s_t = float(tvoc.bow_score(b_t, b_t.flip(0)))
    assert abs(s_t - s_j) < BOW_ATOL


def _databases(vj, vt, cap):
    return JDatabase(vocab=vj, capacity=cap), TDatabase(vocab=vt, capacity=cap, device="cpu")


def test_database_loop_candidates_match_jax():
    """test_vocabulary.test_database_loop_candidates on both packages."""
    rng = np.random.default_rng(2)
    vj, vt = _vocabs(dict(k=4, levels=3, n_train=4000))
    dj, dt = _databases(vj, vt, 16)
    valid = np.ones(256, bool)
    descs = [rand_desc(rng, 256) for _ in range(8)]
    for i, d in enumerate(descs):
        dj.add(i, jnp.asarray(d), jnp.asarray(valid), map_id=0)
        dt.add(i, _t(d), torch.from_numpy(valid), map_id=0)
    q = perturb(rng, descs[2], 6)
    _, qj = jvoc.make_transform(vj)(jnp.asarray(q), jnp.asarray(valid))
    _, qt = tvoc.make_transform(vt, "cpu")(_t(q), torch.from_numpy(valid))
    covis = np.zeros(16, bool)
    covis[6] = covis[7] = True
    cj, sj = dj.detect_loop_candidates(9, qj, covis)
    ct, st = dt.detect_loop_candidates(9, qt, covis)
    np.testing.assert_allclose(st, np.asarray(sj), rtol=0, atol=BOW_ATOL)
    np.testing.assert_array_equal(ct, cj)
    assert 2 in ct[:2] and 6 not in ct and 7 not in ct
    # an erased slot stops scoring as a candidate on both
    dj.erase_many([2])
    dt.erase_many([2])
    cj, _ = dj.detect_loop_candidates(9, qj, covis)
    ct, _ = dt.detect_loop_candidates(9, qt, covis)
    np.testing.assert_array_equal(ct, cj)
    assert 2 not in ct


def test_database_map_match_candidates_match_jax():
    """test_vocabulary.test_database_map_match_excludes_own_map on both
    packages, with the database grown past its capacity."""
    rng = np.random.default_rng(3)
    vj, vt = _vocabs(dict(k=4, levels=3, n_train=4000))
    dj, dt = _databases(vj, vt, 2)
    valid = np.ones(128, bool)
    d_own = rand_desc(rng, 128)
    rows = [(0, d_own, 1), (1, perturb(rng, d_own, 4), 1), (2, perturb(rng, d_own, 4), 2),
            (5, rand_desc(rng, 128), 2)]
    for slot, d, mid in rows:
        dj.add(slot, jnp.asarray(d), jnp.asarray(valid), map_id=mid)
        dt.add(slot, _t(d), torch.from_numpy(valid), map_id=mid)
    assert dt.capacity == dj.capacity >= 6
    _, qj = jvoc.make_transform(vj)(jnp.asarray(d_own), jnp.asarray(valid))
    _, qt = tvoc.make_transform(vt, "cpu")(_t(d_own), torch.from_numpy(valid))
    np.testing.assert_allclose(dt.scores(qt).numpy(), np.asarray(dj.scores(qj)), rtol=0,
                               atol=BOW_ATOL)
    cj, _ = dj.detect_map_match_candidates(qj, own_map_id=1)
    ct, _ = dt.detect_map_match_candidates(qt, own_map_id=1)
    np.testing.assert_array_equal(ct, cj)
    assert 0 not in ct and 1 not in ct and 2 in ct
