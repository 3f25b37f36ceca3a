"""Keyframe database for loop / map-match candidate retrieval.

Counterpart of ``motioncheck_ccm_slam_tpu/models/database.py``, which
replaces the reference ``KeyFrameDatabase`` (src/Database.cpp): the DBoW2
inverted file becomes a dense (NK, n_words) f32 BoW matrix on the device,
and candidate retrieval for a query keyframe is one matrix-vector score
and a mask:

- ``detect_loop_candidates``    — excludes the query's covisibility group and
  gates on the min score among covis neighbors (reference
  DetectLoopCandidates, Database.h:75);
- ``detect_map_match_candidates`` — excludes all KFs of the query's own map
  (reference DetectMapMatchCandidates, Database.h:76).

Inserts are buffered and written as one scatter before the next read.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import vocabulary as vocab_mod


@dataclasses.dataclass
class KeyFrameDatabase:
    """BoW matrix over KF slots of one or more maps (server-shared)."""

    vocab: vocab_mod.Vocabulary
    capacity: int
    device: torch.device | str = "cuda"
    bow: torch.Tensor = None            # (NK, n_words) f32
    present: torch.Tensor = None        # (NK,) bool
    map_id: torch.Tensor = None         # (NK,) i32 owning map (for exclusions)
    _transform: object = None
    # inserts are buffered and flushed as ONE batched scatter before the
    # next read (a row write per insert would copy the whole matrix)
    _pending: list = None

    def __post_init__(self):
        dev = torch.device(self.device)
        if self.bow is None:
            self.bow = torch.zeros((self.capacity, self.vocab.n_words), dtype=torch.float32,
                                   device=dev)
        if self.present is None:
            self.present = torch.zeros((self.capacity,), dtype=torch.bool, device=dev)
        if self.map_id is None:
            self.map_id = torch.full((self.capacity,), -1, dtype=torch.int32, device=dev)
        self._transform = vocab_mod.make_transform(self.vocab, dev)
        self._pending = []

    def _grow(self, need: int):
        new_cap = max(self.capacity * 2, need)
        pad = new_cap - self.capacity
        dev = self.bow.device
        self.bow = torch.cat([self.bow, torch.zeros((pad, self.bow.shape[1]),
                                                    dtype=self.bow.dtype, device=dev)], 0)
        self.present = torch.cat([self.present, torch.zeros((pad,), dtype=torch.bool,
                                                            device=dev)], 0)
        self.map_id = torch.cat([self.map_id, torch.full((pad,), -1, dtype=torch.int32,
                                                         device=dev)], 0)
        self.capacity = new_cap

    def add(self, slot: int, desc, feat_valid, map_id: int = 0) -> torch.Tensor:
        """Compute and buffer the BoW of a keyframe (reference add()). Grows
        with the map blocks (slots are append-only)."""
        if slot >= self.capacity:
            self._grow(slot + 1)
        _, v = self._transform(desc, feat_valid)
        self._pending.append((slot, v, map_id))
        return v

    def _flush(self):
        if not self._pending:
            return
        dev = self.bow.device
        # a slot added twice keeps its last BoW, as a sequential write would
        last = {s: (v, m) for s, v, m in self._pending}
        slots = torch.tensor(list(last), dtype=torch.int64, device=dev)
        vs = torch.stack([v for v, _ in last.values()])
        mids = torch.tensor([m for _, m in last.values()], dtype=torch.int32, device=dev)
        self.bow = self.bow.index_put((slots,), vs)
        self.present = self.present.index_fill(0, slots, True)
        self.map_id = self.map_id.index_put((slots,), mids)
        self._pending.clear()

    def erase(self, slot: int):
        self._pending = [p for p in self._pending if p[0] != slot]
        self.present = self.present.index_fill(
            0, torch.tensor([slot], device=self.present.device), False)

    def erase_many(self, slots):
        """Batched erase (reference KeyFrameDatabase::erase is called for
        every culled / Motion-Check-deleted KF — src/KeyFrame.cpp:850,1171,
        src/Database.cpp:45). One scatter, not one device op per slot."""
        slots = np.asarray(slots, np.int64)
        if len(slots) == 0:
            return
        drop = set(int(s) for s in slots)
        self._pending = [p for p in self._pending if p[0] not in drop]
        self.present = self.present.index_fill(
            0, torch.from_numpy(slots).to(self.present.device), False)

    def scores(self, query_bow: torch.Tensor) -> torch.Tensor:
        """(NK,) similarity of a query BoW against every stored KF."""
        self._flush()
        return vocab_mod.bow_score(query_bow[None, :], self.bow)

    # ------------------------------------------------------------------
    def detect_loop_candidates(self, query_slot: int, query_bow,
                               covis_mask: np.ndarray, min_score_floor=0.015,
                               top_k: int = 8):
        """Loop candidates: best-scoring present KFs outside the query's
        covisibility group, above the min covis score (reference
        DetectLoopCandidates). Returns (slots, host scores)."""
        s = self.scores(query_bow).cpu().numpy()   # scores() flushes pending
        present = self.present.cpu().numpy()
        # min score among covis neighbors defines the bar
        covis_scores = s[covis_mask & present]
        min_score = max(float(covis_scores.min()) if len(covis_scores) else 0.0,
                        min_score_floor)
        cand_mask = present & ~covis_mask
        cand_mask[query_slot] = False
        idx = np.flatnonzero(cand_mask & (s >= min_score))
        return idx[np.argsort(-s[idx])][:top_k], s

    def detect_map_match_candidates(self, query_bow, own_map_id: int,
                                    min_score: float = 0.05, top_k: int = 8):
        """Cross-map candidates: exclude the query's own map (reference
        DetectMapMatchCandidates). Returns (rows, host scores)."""
        s = self.scores(query_bow).cpu().numpy()
        mask = self.present.cpu().numpy() & (self.map_id.cpu().numpy() != own_map_id)
        idx = np.flatnonzero(mask & (s >= min_score))
        return idx[np.argsort(-s[idx])][:top_k], s
