"""Query Context Generator (paper §4.2).

Three feature extractors feed the context vector x_t = [l_t, c_t, p_t]:

  * TaskClassifier   — logistic regression over instruction embeddings (§4.2.1)
  * OnlineKMeans     — cosine-assignment online k-means over full-query
                       embeddings with incremental centroid updates (§4.2.2,
                       Eq. 9–10)
  * FleschComplexity — Flesch Reading Ease (Eq. 11) + equal-width binning
                       (§4.2.3)

Categorical features are one-hot encoded with an intercept appended (§4.2.4):
d = N_tasks + K + N_bins + 1.

Two featurization placements share this module (``RouterConfig.featurize``):
the host numpy path (``ContextGenerator.batch`` — the reference
implementation) and the device path, whose pieces live here —
``kmeans_update_scan`` replays the Eq. 10 sequential centroid updates row
by row in arrival order on the device, and ``kmeans_assign_batch`` is the
read-only assignment.  The router composes them with the
``kernels/featurize`` and ``kernels/linucb`` kernels into one decision
function; the two placements agree exactly.  The cache's read-only
admission probe (``ContextGenerator.probe_batch`` → ``_probe_pipeline``)
runs the featurize kernel, the classifier logits and
``kmeans_assign_batch`` the same way, and writes no state.
"""
from __future__ import annotations

import re
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.embedding import EmbeddingModel, tokenize
from repro_torch.core.residency import TransferLedger
from repro_torch.core.types import ContextVector, N_TASKS, RouterConfig
from repro_torch.device import resolve_device, sync
from repro_torch.kernels.featurize import hashed_embed
from repro_torch.kernels.featurize.ops import pad_pow2

# ---------------------------------------------------------------------------
# Task classifier: LR over embeddings, trained with full-batch Adam.
# ---------------------------------------------------------------------------


def _lr_loss(w, b, x, y, l2=1e-4):
    logp = torch.log_softmax(x @ w + b, dim=-1)
    nll = -torch.mean(torch.gather(logp, 1, y[:, None]))
    return nll + l2 * torch.sum(w * w)


class TaskClassifier:
    """Lightweight LR task-type classifier (paper §4.2.1).

    The instruction text is taken from the first lines of the prompt,
    embedded, and classified into one of N_TASKS labels.  ``w``/``b`` live
    on ``device`` (None: the card, see ``resolve_device``).
    """

    def __init__(self, embedder: EmbeddingModel, n_classes: int = N_TASKS,
                 instr_lines: int = 2, seed: int = 0, device=None):
        self.embedder = embedder
        self.n_classes = n_classes
        self.instr_lines = instr_lines
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        w0 = (rng.standard_normal((embedder.dim, n_classes)) * 0.01)
        self.w = torch.tensor(w0, dtype=torch.float32, device=self.device)
        self.b = torch.zeros((n_classes,), dtype=torch.float32,
                             device=self.device)
        self._trained = False

    def instruction_text(self, text: str) -> str:
        lines = [ln for ln in text.splitlines() if ln.strip()]
        return " ".join(lines[: self.instr_lines]) if lines else text

    def fit(self, texts: Sequence[str], labels: Sequence[int],
            steps: int = 300, lr: float = 0.05) -> float:
        """Train with full-batch Adam (autograd gradients, the same moment
        arithmetic as the JAX package); returns final training accuracy."""
        x = torch.from_numpy(self.embedder.encode_batch(
            [self.instruction_text(t) for t in texts])).to(self.device)
        y = torch.as_tensor(np.asarray(labels, dtype=np.int64),
                            device=self.device)
        params = [self.w.clone(), self.b.clone()]
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
        for t in range(1, steps + 1):
            for p in params:
                p.requires_grad_(True)
            loss = _lr_loss(params[0], params[1], x, y)
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                tt = torch.tensor(float(t), dtype=torch.float32)
                c1 = 1 - torch.tensor(0.9, dtype=torch.float32) ** tt
                c2 = 1 - torch.tensor(0.999, dtype=torch.float32) ** tt
                new = []
                for i, (p, g) in enumerate(zip(params, grads)):
                    m[i] = 0.9 * m[i] + 0.1 * g
                    v[i] = 0.999 * v[i] + 0.001 * g * g
                    mh = m[i] / c1.to(self.device)
                    vh = v[i] / c2.to(self.device)
                    new.append(p.detach() - lr * mh / (torch.sqrt(vh) + 1e-8))
                params = new
        self.w, self.b = params[0].detach(), params[1].detach()
        self._trained = True
        with torch.no_grad():
            pred = torch.argmax(x @ self.w + self.b, dim=1)
        return float((pred == y).float().mean())

    def predict(self, text: str) -> int:
        return int(self.predict_batch([text])[0])

    def predict_batch(self, texts: Sequence[str]) -> np.ndarray:
        """Classify a batch in one embed + one matmul; (len(texts),) labels."""
        e = torch.from_numpy(self.embedder.encode_batch(
            [self.instruction_text(t) for t in texts])).to(self.device)
        with torch.no_grad():
            return torch.argmax(e @ self.w + self.b, dim=1).cpu().numpy()

    def state_dict(self) -> dict:
        return {"w": self.w.cpu().numpy(), "b": self.b.cpu().numpy()}

    def load_state_dict(self, d: dict) -> None:
        self.w = torch.tensor(np.asarray(d["w"], np.float32),
                              device=self.device)
        self.b = torch.tensor(np.asarray(d["b"], np.float32),
                              device=self.device)
        self._trained = True


# ---------------------------------------------------------------------------
# Online k-means (paper Eq. 9-10): cosine assignment, incremental update.
# ---------------------------------------------------------------------------


class OnlineKMeans:
    """Online k-means with cosine assignment and decaying-rate updates.

    Holds TWO synchronized copies of (centroids, counts, initialized):

      * the host numpy mirror — the Eq. 9–10 reference implementation
        (``assign``/``update``) and what ``state_dict`` serializes;
      * a cached device tuple — what the router's fused decision function
        reads and writes.  ``load_device_state`` just swaps the cached
        tuple (no download), so steady-state device routing moves *no*
        k-means state across the host↔device boundary; the host mirror is
        refreshed lazily (``_sync_host``) only when something reads it.

    ``transfers`` counts every actual upload/download of this state.
    """

    def __init__(self, k: int, dim: int, device=None):
        if k < 1:
            raise ValueError("k must be >= 1")
        self.k = k
        self.dim = dim
        self.device = resolve_device(device)
        self._h_centroids = np.zeros((k, dim), dtype=np.float32)
        self._h_counts = np.zeros((k,), dtype=np.int64)
        self._h_init = 0  # first K distinct embeddings seed the centroids
        # device residency: cached (centroids f32, counts f32, init i32)
        # tuple, or None when the host mirror is newer / nothing uploaded
        self._dev: Optional[tuple] = None
        self._host_stale = False     # device copy has updates host lacks
        self.transfers = TransferLedger()

    # -- host/device mirror plumbing ----------------------------------------

    def _sync_host(self) -> None:
        """Refresh the host mirror from the device copy (one download)."""
        if self._host_stale:
            cent, cnt, ini = self._dev
            self._h_centroids = cent.cpu().numpy().astype(np.float32)
            self._h_counts = np.rint(cnt.cpu().numpy()).astype(np.int64)
            self._h_init = int(ini)
            self._host_stale = False
            self.transfers.count_d2h()

    def _invalidate_device(self) -> None:
        """Host-side mutation: drop the (now stale) device copy."""
        self._dev = None

    @property
    def centroids(self) -> np.ndarray:
        self._sync_host()
        return self._h_centroids

    @property
    def counts(self) -> np.ndarray:
        self._sync_host()
        return self._h_counts

    @property
    def _initialized(self) -> int:
        self._sync_host()
        return self._h_init

    def assign(self, e: np.ndarray) -> int:
        """Eq. 9: argmax_c cos(e, mu_c) over initialized centroids."""
        self._sync_host()
        live = max(self._h_init, 1)
        c = self._h_centroids[:live]
        norms = np.linalg.norm(c, axis=1) * max(np.linalg.norm(e), 1e-12)
        sims = (c @ e) / np.maximum(norms, 1e-12)
        return int(np.argmax(sims))

    def update(self, e: np.ndarray) -> int:
        """Assign, then apply the Eq. 10 incremental centroid update."""
        self._sync_host()
        self._invalidate_device()
        e = np.asarray(e, dtype=np.float32)
        if self._h_init < self.k:
            # seed from the first K distinct embeddings (paper §4.2.2)
            for i in range(self._h_init):
                if np.allclose(self._h_centroids[i], e, atol=1e-6):
                    break
            else:
                idx = self._h_init
                self._h_centroids[idx] = e
                self._h_counts[idx] = 1
                self._h_init += 1
                return idx
        c = self.assign(e)
        n = self._h_counts[c]
        self._h_centroids[c] += (e - self._h_centroids[c]) / (n + 1)
        self._h_counts[c] += 1
        return c

    def state_dict(self) -> dict:
        self._sync_host()
        return {"centroids": self._h_centroids.copy(),
                "counts": self._h_counts.copy(),
                "initialized": self._h_init}

    def load_state_dict(self, d: dict) -> None:
        self._host_stale = False
        self._invalidate_device()
        self._h_centroids = np.asarray(d["centroids"], dtype=np.float32).copy()
        self._h_counts = np.asarray(d["counts"], dtype=np.int64).copy()
        self._h_init = int(d["initialized"])

    # -- device path (fused featurize→score pipeline) -----------------------

    def device_state(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(centroids, counts, initialized) as device tensors for the
        Eq. 9–10 replay (counts as float32: exact for any realistic stream,
        and the Eq. 10 step divides by them).  Cached: uploads once after a
        host-side mutation, then returns the resident tuple for free."""
        if self._dev is None:
            self._dev = (
                torch.from_numpy(self._h_centroids.copy()).to(self.device),
                torch.from_numpy(self._h_counts.astype(np.float32)).to(
                    self.device),
                torch.tensor(self._h_init, dtype=torch.int32,
                             device=self.device))
            self.transfers.count_h2d()
        return self._dev

    def load_device_state(self, centroids, counts, initialized) -> None:
        """Adopt an update's output tensors as the resident state.  No
        download happens here — the host mirror is marked stale and
        refreshed lazily on its next read."""
        self._dev = (centroids, counts, initialized)
        self._host_stale = True

    def update_batch_device(self, embs: np.ndarray) -> np.ndarray:
        """Assign + update a whole batch on the device, keeping the state
        device-resident; returns (Q,) cluster ids.  Semantically identical
        to Q sequential ``update`` calls — the rows replay the Eq. 10
        centroid shifts in arrival order."""
        cent, cnt, ini = self.device_state()
        cent, cnt, ini, clusters = kmeans_update_scan(
            cent, cnt, ini, torch.as_tensor(np.asarray(embs, np.float32),
                                            device=self.device))
        self.load_device_state(cent, cnt, ini)
        return clusters.cpu().numpy().astype(np.int64)


def kmeans_update_scan(centroids, counts, initialized, embs, valid=None):
    """Eq. 9–10 over a batch, one row at a time in arrival order.

    Each row replays exactly what ``OnlineKMeans.update`` does on host:
    seed the next free centroid when fewer than K *distinct* embeddings
    have been seen (distinctness = np.allclose's |c−e| ≤ atol + rtol·|e|
    with atol=1e-6, rtol=1e-5), otherwise cosine-assign over the live
    centroids and apply the incremental update μ_c += (e−μ_c)/(N_c+1).
    The sequential dependency is intrinsic — each update shifts the
    centroid the next assignment sees.  Every step is a handful of small
    tensor operations on the inputs' device with no host synchronization
    (the branches are ``torch.where`` selections), mirroring the JAX
    package's ``lax.scan`` step by step.

    centroids: (K, D) f32; counts: (K,) f32; initialized: () i32;
    embs: (Q, D) f32 → (centroids', counts', initialized', clusters (Q,)).
    ``valid`` (Q,) bool marks real rows — padding rows leave the state
    untouched and get cluster 0.
    """
    k = centroids.shape[0]
    dev = embs.device
    idx = torch.arange(k, device=dev)
    if valid is None:
        valid = torch.ones(embs.shape[0], dtype=torch.bool, device=dev)
    cent, cnt, ini = centroids, counts, initialized
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    clusters = []
    for i in range(embs.shape[0]):
        e, v = embs[i], valid[i]
        close = torch.all(
            torch.abs(cent - e[None, :]) <= 1e-6 + 1e-5 * torch.abs(e)[None, :],
            dim=1)
        is_dup = torch.any(close & (idx < ini))
        can_seed = (ini < k) & ~is_dup
        # Eq. 9 assignment over the live centroids (at least one)
        live = torch.clamp(ini, min=1)
        norms = torch.linalg.vector_norm(cent, dim=1) \
            * torch.clamp(torch.linalg.vector_norm(e), min=1e-12)
        sims = (cent @ e) / torch.clamp(norms, min=1e-12)
        c = torch.argmax(torch.where(idx < live, sims, neg_inf)).to(torch.int32)
        at_c = (idx == c)
        # index_select with a 1-element index tensor: indexing with a 0-d
        # tensor would read it back to the host (a sync per row)
        c1 = c.long().view(1)
        delta = ((e - torch.index_select(cent, 0, c1)[0])
                 / (torch.index_select(cnt, 0, c1)[0] + 1.0))
        upd_cent = torch.where(at_c[:, None], cent + delta[None, :], cent)
        upd_cnt = torch.where(at_c, cnt + 1.0, cnt)
        at_seed = idx == torch.clamp(ini, max=k - 1)   # unused when full
        seed_cent = torch.where(at_seed[:, None], e[None, :], cent)
        seed_cnt = torch.where(at_seed, torch.ones_like(cnt), cnt)
        new_cent = torch.where(can_seed, seed_cent, upd_cent)
        new_cnt = torch.where(can_seed, seed_cnt, upd_cnt)
        clusters.append(torch.where(v, torch.where(can_seed, ini, c), zero))
        cent = torch.where(v, new_cent, cent)
        cnt = torch.where(v, new_cnt, cnt)
        ini = ini + (v & can_seed).to(ini.dtype)
    out = (torch.stack(clusters) if clusters
           else torch.zeros(0, dtype=torch.int32, device=dev))
    return cent, cnt, ini, out


def kmeans_assign_batch(centroids, initialized, embs):
    """Read-only Eq. 9 assignment for a batch: no state change, so the rows
    vectorize — identical to Q independent ``assign`` calls on the same
    centroids."""
    k = centroids.shape[0]
    live = torch.clamp(initialized, min=1)
    cnorm = torch.linalg.vector_norm(centroids, dim=1)                 # (K,)
    enorm = torch.clamp(torch.linalg.vector_norm(embs, dim=1), min=1e-12)
    sims = (embs @ centroids.T) / torch.clamp(
        cnorm[None, :] * enorm[:, None], min=1e-12)
    sims = torch.where(torch.arange(k, device=embs.device)[None, :] < live,
                       sims, torch.tensor(float("-inf"), device=embs.device))
    return torch.argmax(sims, dim=1).to(torch.int32)


def _probe_pipeline(ids, weights, proj, w, b, centroids, initialized, *,
                    n: int, use_task: bool, use_cluster: bool):
    """Read-only probe: featurize (the full texts, plus the instruction
    slices when the task feature is on, stacked into one call of the
    featurize kernel's wrapper — the kernel on the card, its plain
    version on the CPU) → classifier logits → Eq. 9 assignment.  ``n``
    is the padded row count of each half.  No state is written."""
    e = hashed_embed(ids, weights, proj)
    emb, emb_i = e[:n], e[n:]
    dev = e.device
    if use_task:
        labels = torch.argmax(emb_i @ w + b, dim=1).to(torch.int32)
    else:
        labels = torch.zeros((n,), dtype=torch.int32, device=dev)
    if use_cluster:
        clusters = kmeans_assign_batch(centroids, initialized, emb)
    else:
        clusters = torch.zeros((n,), dtype=torch.int32, device=dev)
    return labels, clusters, emb


def _pad_cols(a: np.ndarray, width: int, fill) -> np.ndarray:
    """Right-pad a (Q, L) feature tensor to L=width (stacking full-text and
    instruction rows into one kernel call needs a common L)."""
    if a.shape[1] == width:
        return a
    return np.pad(a, ((0, 0), (0, width - a.shape[1])),
                  constant_values=fill)


def _pad_rows(a: np.ndarray, q_pad: int, fill) -> np.ndarray:
    """Bottom-pad an (n, L) tensor to q_pad rows."""
    if q_pad == a.shape[0]:
        return a
    out = np.full((q_pad, a.shape[1]), fill, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


# ---------------------------------------------------------------------------
# Flesch Reading Ease (Eq. 11) + equal-width binning.
# ---------------------------------------------------------------------------

_SENT_SPLIT = re.compile(r"[.!?]+")
_VOWEL_GROUPS = re.compile(r"[aeiouy]+")


def count_syllables(word: str) -> int:
    w = word.lower().strip("'")
    if not w:
        return 0
    groups = _VOWEL_GROUPS.findall(w)
    n = len(groups)
    if w.endswith("e") and n > 1 and not w.endswith(("le", "ee", "ye")):
        n -= 1  # silent final e
    return max(n, 1)


def flesch_counts(text: str) -> Tuple[int, int, int]:
    """(words, sentences, syllables) — the integer sufficient statistics
    of Eq. 11.  The string/regex work stays on host; the score arithmetic
    can then run wherever the bins are consumed — the fused device
    pipeline computes score+bin from these counts with the exact float32
    op order of ``flesch_score_from_counts``.  Sentences are clamped to
    >= 1 so the ratio is always defined."""
    words = tokenize(text)
    sentences = max(len([s for s in _SENT_SPLIT.split(text) if s.strip()]),
                    1)
    syllables = sum(count_syllables(w) for w in words)
    return len(words), sentences, syllables


def flesch_score_from_counts(n_words: int, n_sentences: int,
                             n_syllables: int) -> float:
    """Eq. 11 from the counts, in float32 with a fixed op order — the
    single arithmetic spec both the host reference path and the device
    pipeline implement, so host/device bins agree bitwise.  Zero words
    (empty/punctuation-only text) scores 100.0 (trivially simple)."""
    if n_words == 0:
        return 100.0
    ws = np.float32(n_words) / np.float32(n_sentences)
    sw = np.float32(n_syllables) / np.float32(n_words)
    score = (np.float32(206.835) - np.float32(1.015) * ws
             - np.float32(84.6) * sw)
    return float(np.clip(score, np.float32(0.0), np.float32(100.0)))


def flesch_reading_ease(text: str) -> float:
    """Eq. 11; clamped to [0, 100] as the paper bins in that range."""
    return flesch_score_from_counts(*flesch_counts(text))


def flesch_score_bin_device(comp_counts: torch.Tensor, lo: torch.Tensor,
                            width: torch.Tensor, n_bins: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 11 score + equal-width bin from the (Q, 3) int32 (words,
    sentences, syllables) counts on the device — the float32 op-order
    mirror of ``flesch_score_from_counts`` + ``FleschComplexity.bin``
    (every constant a float32 tensor, one operation per step, so host and
    device produce identical bins)."""
    f32 = dict(dtype=torch.float32, device=comp_counts.device)
    w_ = comp_counts[:, 0].to(torch.float32)
    s_ = comp_counts[:, 1].to(torch.float32)
    sy = comp_counts[:, 2].to(torch.float32)
    # W >= 1 on selected rows, so max(W, 1) == W there; it only guards
    # the masked-off W == 0 branch from dividing by zero
    ws = w_ / s_
    sw = sy / torch.clamp(w_, min=1.0)
    raw = (torch.tensor(206.835, **f32) - torch.tensor(1.015, **f32) * ws
           - torch.tensor(84.6, **f32) * sw)
    hundred = torch.tensor(100.0, **f32)
    scores = torch.where(w_ > 0, torch.clamp(raw, 0.0, 100.0), hundred)
    bins = torch.clamp(((scores - lo) / width).to(torch.int32), 0, n_bins - 1)
    return scores, bins


class FleschComplexity:
    """Score + equal-width binning into N_bins categories (paper §4.2.3)."""

    def __init__(self, n_bins: int, lo: float = 0.0, hi: float = 100.0):
        if n_bins < 1:
            raise ValueError("n_bins must be >= 1")
        self.n_bins = n_bins
        self.lo, self.hi = lo, hi

    @property
    def bin_width32(self) -> np.float32:
        """Equal-bin width in float32 — the scalar the device binning
        stage consumes (must match ``bin``'s arithmetic exactly)."""
        return np.float32(self.hi - self.lo) / np.float32(self.n_bins)

    def score(self, text: str) -> float:
        return flesch_reading_ease(text)

    def bin(self, score: float) -> int:
        # float32 with int truncation toward zero — mirrored by the device
        # pipeline's (score - lo) / width → int32 cast
        b = int((np.float32(score) - np.float32(self.lo)) / self.bin_width32)
        return int(np.clip(b, 0, self.n_bins - 1))

    def __call__(self, text: str) -> Tuple[float, int]:
        s = self.score(text)
        return s, self.bin(s)


# ---------------------------------------------------------------------------
# Context vectorizer: one-hot + intercept (paper §4.2.4).
# ---------------------------------------------------------------------------


class ContextGenerator:
    """Combines the three extractors into x_t ∈ R^d (d = N_tasks+K+N_bins+1).
    Device-side state (classifier weights, the k-means device copy) lives
    on ``device`` (None: the card, see ``resolve_device``)."""

    def __init__(self, config: RouterConfig,
                 embedder: Optional[EmbeddingModel] = None, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.embedder = embedder or EmbeddingModel()
        self.task_classifier = TaskClassifier(
            self.embedder, n_classes=config.n_tasks, seed=config.seed,
            device=self.device)
        self.kmeans = OnlineKMeans(config.n_clusters, self.embedder.dim,
                                   device=self.device)
        self.complexity = FleschComplexity(config.n_complexity_bins)
        # feature toggles for the ablation study (paper §6.2.3)
        self.use_task = True
        self.use_cluster = True
        self.use_complexity = True
        # "featurize" is the device path's host hashing pass; on the host
        # path it stays 0 (hashing is inside the task/cluster stages there)
        self.timings_ms = {"task": 0.0, "cluster": 0.0, "complexity": 0.0,
                           "featurize": 0.0, "n": 0}

    def set_features(self, task: bool = True, cluster: bool = True,
                     complexity: bool = True) -> None:
        self.use_task, self.use_cluster, self.use_complexity = task, cluster, complexity

    @property
    def dim(self) -> int:
        return self.config.context_dim

    def encode(self, task_label: int, cluster: int, comp_bin: int) -> np.ndarray:
        cfg = self.config
        x = np.zeros(cfg.context_dim, dtype=np.float32)
        if self.use_task:
            x[task_label] = 1.0
        if self.use_cluster:
            x[cfg.n_tasks + cluster] = 1.0
        if self.use_complexity:
            x[cfg.n_tasks + cfg.n_clusters + comp_bin] = 1.0
        x[-1] = 1.0  # intercept
        return x

    def __call__(self, text: str) -> ContextVector:
        # the batch-of-one: keeps the sequential and batched featurization
        # paths structurally identical (route_batch's equivalence guarantee)
        return self.batch([text])[0]

    def batch(self, texts: Sequence[str],
              embeddings: Optional[np.ndarray] = None,
              task_labels: Optional[np.ndarray] = None) -> list:
        """Featurize a query batch: List[ContextVector], index-aligned.

        Embedding + task classification are vectorized; the k-means
        centroid updates (Eq. 10) stay sequential in arrival order because
        each update shifts the centroid the next assignment sees — this is
        exactly what Q successive ``__call__``s would compute, so batched
        and sequential featurization agree bitwise.

        ``embeddings`` (n, dim) / ``task_labels`` (n,), optional: reuse
        feature work a caller already did on the same texts.  The embedder
        and classifier are deterministic, so passing their own outputs back
        is bitwise identical to recomputing — the k-means *updates* still
        happen here, in arrival order.
        """
        if not texts:
            return []
        n = len(texts)
        t0 = time.perf_counter()
        if not self.use_task:
            task_labels = np.zeros(n, dtype=np.int64)
        elif task_labels is None:
            task_labels = self.task_classifier.predict_batch(texts)
        sync(self.device)                     # timing boundary, not pipeline
        t1 = time.perf_counter()
        if self.use_cluster:
            embs = (embeddings if embeddings is not None
                    else self.embedder.encode_batch(texts))
            clusters = [self.kmeans.update(e) for e in embs]
        else:
            clusters = [0] * n
        t2 = time.perf_counter()
        comp = ([self.complexity(t) for t in texts] if self.use_complexity
                else [(100.0, 0)] * n)
        t3 = time.perf_counter()
        self.timings_ms["task"] += (t1 - t0) * 1e3
        self.timings_ms["cluster"] += (t2 - t1) * 1e3
        self.timings_ms["complexity"] += (t3 - t2) * 1e3
        self.timings_ms["n"] += n
        return self.make_contexts(task_labels, clusters, comp)

    def make_contexts(self, task_labels, clusters, comp) -> List[ContextVector]:
        """Index-aligned ContextVectors from per-query (label, cluster,
        (score, bin)) triples — shared by the host and device paths (the
        one-hot layout is ``encode``'s, identically 0/1 on both)."""
        return [ContextVector(
            task_label=int(task_labels[i]), cluster=int(clusters[i]),
            complexity_bin=comp[i][1], complexity_score=comp[i][0],
            vector=self.encode(int(task_labels[i]), int(clusters[i]),
                               comp[i][1]))
            for i in range(len(task_labels))]

    # -- device featurization (the fused featurize→score pipeline) ----------

    @property
    def device_active(self) -> bool:
        """True when featurization should run through the device pipeline
        (``RouterConfig.featurize`` toggle; "auto" = CUDA only)."""
        return self.config.resolve_featurize_device(self.device)

    def complexity_counts_batch(self, texts: Sequence[str]) -> np.ndarray:
        """Host half of the Flesch stage: the (Q, 3) int32
        (words, sentences, syllables) count matrix.  Only the
        string/regex tokenization stays on host — the Eq. 11 score and
        equal-width binning run inside the fused device pipeline from
        these counts.  With complexity ablated the counts are all-zero
        (sentences clamped to 1), which the device maps to score 100.0 /
        bin 0 — the same sentinel the host path uses."""
        if self.use_complexity:
            counts = [flesch_counts(t) for t in texts]
        else:
            counts = [(0, 1, 0)] * len(texts)
        return np.asarray(counts, dtype=np.int32).reshape(len(texts), 3)

    def instruction_features(self, texts: Sequence[str]
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """Hashed (ids, weights) for the classifier's instruction slices."""
        return self.embedder.hashed_features(
            [self.task_classifier.instruction_text(t) for t in texts])

    def padded_feature_tensors(self, texts: Sequence[str], want_full: bool,
                               want_instr: bool, q_pad: int
                               ) -> Tuple[np.ndarray, np.ndarray]:
        """Stacked, padded (ids, weights) for the fused device pipeline:
        the full-text half (when ``want_full``) followed by the
        instruction half (when ``want_instr``), each column-padded to one
        power-of-two L (floor 128, fill id −1 / weight 0) and row-padded
        to ``q_pad`` — the single owner of the layout the router's
        ``_fused_decide`` slices at the padded boundary (``e[:q_pad]`` /
        ``e[q_pad:]``)."""
        halves = []
        if want_full:
            halves.append(self.embedder.hashed_features(texts))
        if want_instr:
            halves.append(self.instruction_features(texts))
        width = pad_pow2(max(h[0].shape[1] for h in halves), floor=128)
        ids = np.concatenate(
            [_pad_rows(_pad_cols(i, width, -1), q_pad, -1)
             for i, _ in halves])
        weights = np.concatenate(
            [_pad_rows(_pad_cols(w, width, 0.0), q_pad, 0.0)
             for _, w in halves])
        return ids, weights

    def classifier_params(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.task_classifier.w, self.task_classifier.b

    def record_device_batch(self, n: int, featurize_ms: float,
                            complexity_ms: float) -> None:
        """Account a device-path batch in ``timings_ms`` (the fused
        task+cluster+score time lives in the router's decision clock)."""
        self.timings_ms["featurize"] += featurize_ms
        self.timings_ms["complexity"] += complexity_ms
        self.timings_ms["n"] += n

    def probe_batch(self, texts: Sequence[str]
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Read-only batched features for cache probes: (task labels,
        cluster assignments, unit embeddings), one featurization pass for
        the whole batch.  Mutates nothing — classifier ``predict`` and
        k-means ``assign`` semantics; Eq. 10 updates stay exclusive to
        routing.  On the device path this is one ``_probe_pipeline`` call
        (one featurize launch) whose embeddings the router then reuses
        (the query is embedded once per lifecycle)."""
        n = len(texts)
        if n == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy(), np.zeros((0, self.embedder.dim), np.float32)
        if not self.device_active:
            embs = self.embedder.encode_batch(texts)
            labels = (self.task_classifier.predict_batch(texts)
                      if self.use_task else np.zeros(n, dtype=np.int64))
            clusters = (np.asarray([self.kmeans.assign(e) for e in embs],
                                   dtype=np.int64) if self.use_cluster
                        else np.zeros(n, dtype=np.int64))
            return labels, clusters, embs
        # Q and L padded to powers of two, the layout of the router's
        # device path (padding rows are read-only garbage, sliced off)
        dev = self.device
        q_pad = pad_pow2(n)
        ids, weights = self.padded_feature_tensors(
            texts, want_full=True, want_instr=self.use_task, q_pad=q_pad)
        cent, _, ini = self.kmeans.device_state()
        w, b = self.classifier_params()
        labels, clusters, emb = _probe_pipeline(
            torch.from_numpy(ids).to(dev), torch.from_numpy(weights).to(dev),
            self.embedder.proj_device(dev), w, b, cent, ini, n=q_pad,
            use_task=self.use_task, use_cluster=self.use_cluster)
        return (labels.cpu().numpy().astype(np.int64)[:n],
                clusters.cpu().numpy().astype(np.int64)[:n],
                emb.cpu().numpy()[:n])

    def mean_overhead_ms(self) -> dict:
        n = max(self.timings_ms["n"], 1)
        return {k: v / n for k, v in self.timings_ms.items() if k != "n"}

    def state_dict(self) -> dict:
        return {"task": self.task_classifier.state_dict(),
                "kmeans": self.kmeans.state_dict()}

    def load_state_dict(self, d: dict) -> None:
        self.task_classifier.load_state_dict(d["task"])
        self.kmeans.load_state_dict(d["kmeans"])
