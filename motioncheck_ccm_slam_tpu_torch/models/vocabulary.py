"""Binary bag-of-words vocabulary for place recognition.

Counterpart of ``motioncheck_ccm_slam_tpu/models/vocabulary.py``, which
replaces DBoW2's ``TemplatedVocabulary<FORB>`` (reference
cslam/thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h) with a dense perfect
k-ary tree: centroids per level as (k^(l+1), 8) words, a descent of L
rounds of gather + XOR + popcount + argmin over k children batched over a
frame's descriptors, and a keyframe's BoW as a dense L1-normalized tf-idf
histogram over the k^L leaves.

The training code (hierarchical binary k-medians on numpy) is copied, so
``default_vocabulary`` builds the JAX package's tree bit for bit from the
same seeded PRNG descriptors: no vocabulary file is needed. The transform
runs on torch tensors on ``device``; descriptors are int32 words holding
the uint32 bits (see ops/orb.py).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List

import numpy as np
import torch

from ..ops import matching


def _popcount_np(x):
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _hamming_np(a, b):
    """(N, 8) u32 x (M, 8) u32 -> (N, M) int."""
    x = a[:, None, :] ^ b[None, :, :]
    return _popcount_np(x.reshape(x.shape[0], x.shape[1], -1))


def _majority_centroid(descs):
    """Bitwise-majority centroid of (N, 8) u32 descriptors."""
    bits = np.unpackbits(descs.view(np.uint8), axis=-1)  # (N, 256)
    maj = (bits.sum(0) * 2 >= bits.shape[0]).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def _kmedians(descs, k, rng, iters=8):
    """Binary k-medians with k-means++-style init. Returns (k, 8) u32."""
    n = len(descs)
    if n == 0:
        return rng.integers(0, 2**32, size=(k, 8), dtype=np.uint32)
    # init: first random, rest by max-min distance
    centers = [descs[rng.integers(0, n)]]
    for _ in range(k - 1):
        d = _hamming_np(descs, np.stack(centers)).min(-1)
        centers.append(descs[int(np.argmax(d))])
    C = np.stack(centers)
    for _ in range(iters):
        assign = _hamming_np(descs, C).argmin(-1)
        for j in range(k):
            members = descs[assign == j]
            if len(members):
                C[j] = _majority_centroid(members)
    return C.astype(np.uint32)


@dataclasses.dataclass(frozen=True)
class Vocabulary:
    """Perfect k-ary binary vocabulary of depth L (leaves = k^L words)."""

    k: int
    levels: int
    # centroids[l]: (k^(l+1), 8) u32 — children of level-l nodes laid out so
    # node i's children occupy [i*k, (i+1)*k)
    centroids: tuple          # of np.ndarray
    idf: np.ndarray           # (k^L,) f32 inverse document frequency

    @property
    def n_words(self) -> int:
        return self.k ** self.levels

    def device_arrays(self, device):
        """The centroids as int32 words and the idf, on ``device``."""
        return ([torch.from_numpy(c.view(np.int32).copy()).to(device) for c in self.centroids],
                torch.from_numpy(self.idf).to(device))


def train(descriptors: np.ndarray, k: int = 8, levels: int = 4,
          seed: int = 7, max_per_node: int = 4096) -> Vocabulary:
    """Hierarchical k-medians over a descriptor sample (N, 8) u32."""
    rng = np.random.default_rng(seed)
    descs = descriptors.astype(np.uint32)
    levels_out: List[np.ndarray] = []
    # assignment of each training descriptor to a node of current level
    assign = np.zeros(len(descs), np.int64)
    n_nodes = 1
    for l in range(levels):
        C_level = np.zeros((n_nodes * k, 8), np.uint32)
        new_assign = np.zeros_like(assign)
        for node in range(n_nodes):
            members = descs[assign == node]
            if len(members) > max_per_node:
                members = members[rng.choice(len(members), max_per_node,
                                             replace=False)]
            C = _kmedians(members, k, rng)
            C_level[node * k : (node + 1) * k] = C
        # reassign all descriptors to children
        for node in range(n_nodes):
            sel = assign == node
            if not sel.any():
                continue
            C = C_level[node * k : (node + 1) * k]
            child = _hamming_np(descs[sel], C).argmin(-1)
            new_assign[sel] = node * k + child
        levels_out.append(C_level)
        assign = new_assign
        n_nodes *= k
    # idf from training word histogram
    counts = np.bincount(assign, minlength=n_nodes).astype(np.float64)
    idf = np.log(len(descs) / np.maximum(counts, 1.0)).astype(np.float32)
    return Vocabulary(k=k, levels=levels, centroids=tuple(levels_out), idf=idf)


@functools.lru_cache(maxsize=2)
def default_vocabulary(k: int = 8, levels: int = 4, seed: int = 11,
                       n_train: int = 30000) -> Vocabulary:
    """Deterministic vocabulary trained on PRNG descriptors."""
    rng = np.random.default_rng(seed)
    descs = rng.integers(0, 2**32, size=(n_train, 8), dtype=np.uint32)
    return train(descs, k=k, levels=levels, seed=seed)


# ---------------------------------------------------------------------------
# Device-side transform
# ---------------------------------------------------------------------------

_transform_cache: dict = {}


def make_transform(vocab: Vocabulary, device: torch.device | str = "cuda"):
    """Closure: descriptors (F, 8) int32 + valid (F,) -> (word_ids (F,) i64,
    bow (n_words,) L1-normalized tf-idf vector), on ``device``. Each level
    takes the child of least Hamming distance, the first of equal ones.
    Cached per vocabulary and device: the tree is copied to the device
    once."""
    key = (id(vocab), str(torch.device(device)))
    hit = _transform_cache.get(key)
    if hit is not None and hit[0] is vocab:
        return hit[1]
    cents, idf = vocab.device_arrays(device)
    k = vocab.k
    n_words = vocab.n_words

    def transform(desc: torch.Tensor, valid: torch.Tensor):
        n = desc.shape[0]
        node = torch.zeros(n, dtype=torch.int64, device=desc.device)
        children = torch.arange(k, dtype=torch.int64, device=desc.device)
        for C in cents:
            child_idx = node[:, None] * k + children[None, :]
            d = matching.popcount_u32(C[child_idx] ^ desc[:, None, :]).sum(-1)   # (F, k)
            node = torch.gather(child_idx, 1, torch.argmin(d, -1, keepdim=True))[:, 0]
        ones = valid.to(torch.float32)
        tf = torch.zeros(n_words, dtype=torch.float32, device=desc.device).index_add(
            0, torch.where(valid, node, 0), ones)
        v = tf * idf
        return node, v / torch.clamp_min(torch.sum(torch.abs(v)), 1e-9)

    _transform_cache[key] = (vocab, transform)
    return transform


def bow_score(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """L1 similarity score of two L1-normalized BoW vectors (DBoW2 L1_NORM
    scoring): s = 1 - 0.5*|v1 - v2|_1, batched over leading dims of v2."""
    return 1.0 - 0.5 * torch.sum(torch.abs(v1 - v2), dim=-1)
