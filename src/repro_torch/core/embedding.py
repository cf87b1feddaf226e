"""Deterministic sentence embeddings for the context generator.

The paper uses sentence-transformers/all-MiniLM-L6-v2 (384-d).  This container
is offline, so we provide a pure-numpy hashed n-gram encoder with the same
interface and dimensionality: tokens and character trigrams are hashed into a
fixed-size space, tf-weighted, projected through a fixed random (seeded)
Gaussian matrix, and L2-normalized.  This preserves the two properties the
router actually relies on:

  * queries about similar topics land near each other (shared vocabulary →
    shared hash buckets → similar projections), so online k-means produces
    stable semantic clusters;
  * the map is deterministic and cheap (paper overhead budget: ~3 ms/query).

A real deployment would swap in a MiniLM forward pass behind ``EmbeddingModel``.

Two encode paths share the same hashing:

  * ``encode``/``encode_batch`` — the pure-numpy reference (and the
    router's host-path fallback);
  * ``hashed_features`` + ``kernels/featurize`` — one vectorized host
    pass producing padded ``(Q, L)`` feature-id/weight tensors (string
    work: tokenize + blake2, memoized per token), with the scatter /
    log1p tf / projection / L2 norm fused into one CUDA kernel on the card.
"""
from __future__ import annotations

import hashlib
import re
from typing import List, Sequence, Tuple

import numpy as np
import torch

_TOKEN_RE = re.compile(r"[a-z0-9']+")
_HASH_DIM = 2048
_EMBED_DIM = 384


def _stable_hash(s: str) -> int:
    # Python's hash() is salted per-process; use blake2 for determinism.
    return int.from_bytes(hashlib.blake2b(s.encode(), digest_size=8).digest(), "little")


def tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(text.lower())


class EmbeddingModel:
    """384-d deterministic sentence encoder (drop-in for MiniLM)."""

    def __init__(self, dim: int = _EMBED_DIM, hash_dim: int = _HASH_DIM, seed: int = 1234):
        self.dim = dim
        self.hash_dim = hash_dim
        rng = np.random.default_rng(seed)
        # fixed projection: hashed bag-of-features -> dense embedding
        self._proj = rng.standard_normal((hash_dim, dim)).astype(np.float32)
        self._proj /= np.sqrt(hash_dim)
        self._proj_dev = {}            # device -> tensor copy, built on first use
        # token -> [(bucket, weight)] memo: the blake2 hash of a token and
        # its trigrams depends only on the token, so repeated vocabulary
        # across a batch (and across batches) hashes exactly once.  Flushed
        # wholesale at _MEMO_CAP so a long-lived server over unbounded
        # vocabulary (ids, URLs, noise) can't leak memory — a flush only
        # costs rehashing, never changes a result.
        self._tok_feats: dict = {}
        self._bigram_ids: dict = {}

    def _sparse_counts(self, text: str) -> np.ndarray:
        counts = np.zeros(self.hash_dim, dtype=np.float32)
        for bucket, weight in self._features(text):
            counts[bucket] += weight
        return counts

    def encode(self, text: str) -> np.ndarray:
        """Embed one string -> (dim,) unit vector."""
        counts = self._sparse_counts(text)
        total = counts.sum()
        if total > 0:
            counts = np.log1p(counts)  # sublinear tf
        v = counts @ self._proj
        n = np.linalg.norm(v)
        return (v / n if n > 0 else v).astype(np.float32)

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        if len(texts) == 0:
            return np.zeros((0, self.dim), dtype=np.float32)
        return np.stack([self.encode(t) for t in texts])

    # -- device featurization (kernels/featurize) ---------------------------

    _MEMO_CAP = 262_144

    def _features(self, text: str) -> List[Tuple[int, float]]:
        """One text's hashed (bucket, weight) feature list — THE feature
        definition (word 1.0, char-trigram 0.5, bigram 0.75); both encode
        paths build on it, so host and device can never disagree on what a
        feature is.  Duplicates are kept; dense accumulation and the device
        scatter sum them identically."""
        if (len(self._tok_feats) > self._MEMO_CAP
                or len(self._bigram_ids) > self._MEMO_CAP):
            self._tok_feats.clear()
            self._bigram_ids.clear()
        toks = tokenize(text)
        feats: List[Tuple[int, float]] = []
        for tok in toks:
            cached = self._tok_feats.get(tok)
            if cached is None:
                # char trigrams catch morphology / domain jargon
                cached = [(_stable_hash("w:" + tok) % self.hash_dim, 1.0)]
                padded = f"^{tok}$"
                for i in range(len(padded) - 2):
                    cached.append((
                        _stable_hash("c:" + padded[i:i + 3]) % self.hash_dim,
                        0.5))
                self._tok_feats[tok] = cached
            feats.extend(cached)
        # bigrams give phrase-level signal (cheap MiniLM stand-in)
        for a, b in zip(toks, toks[1:]):
            bg = (a, b)
            h = self._bigram_ids.get(bg)
            if h is None:
                h = self._bigram_ids[bg] = \
                    _stable_hash(f"b:{a}_{b}") % self.hash_dim
            feats.append((h, 0.75))
        return feats

    def hashed_features(self, texts: Sequence[str]
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Texts → padded ``(Q, L)`` int32 bucket ids + float32 tf weights.

        This is the single host pass of the device featurization path:
        tokenization + blake2 hashing (string work that cannot leave the
        host) happens here, memoized per token, and everything downstream —
        scatter, log1p tf, projection, L2 norm — runs in the
        ``kernels/featurize`` kernel.  Padding uses id −1 / weight 0
        (matches no hash bucket); a featureless text (empty/whitespace)
        yields an all-padding row and hence the zero embedding, exactly as
        ``encode`` does."""
        rows = [self._features(t) for t in texts]
        q = len(rows)
        width = max((len(r) for r in rows), default=0)
        ids = np.full((q, max(width, 1)), -1, dtype=np.int32)
        weights = np.zeros((q, max(width, 1)), dtype=np.float32)
        for i, feats in enumerate(rows):
            if feats:
                f = np.asarray(feats, dtype=np.float32)
                ids[i, : len(feats)] = f[:, 0].astype(np.int32)
                weights[i, : len(feats)] = f[:, 1]
        return ids, weights

    def proj_device(self, device) -> torch.Tensor:
        """The fixed projection as a tensor on ``device``, uploaded once per
        device so pure-host users never touch one."""
        device = torch.device(device)
        proj = self._proj_dev.get(device)
        if proj is None:
            proj = self._proj_dev[device] = torch.from_numpy(
                self._proj).to(device)
        return proj

    def encode_batch_device(self, texts: Sequence[str],
                            device) -> np.ndarray:
        """``encode_batch`` through the fused featurization kernel: one host
        hashing pass + one device call.  Agrees with the host reference
        within float32 tolerance."""
        if len(texts) == 0:
            return np.zeros((0, self.dim), dtype=np.float32)
        from repro_torch.kernels.featurize import hashed_embed
        ids, weights = self.hashed_features(texts)
        out = hashed_embed(torch.from_numpy(ids).to(device),
                           torch.from_numpy(weights).to(device),
                           self.proj_device(device))
        return out.cpu().numpy()
