"""Neighbor subsampling: similarity ranking -> diverse graph neighbors.

Port of `relpose_gnn_tpu/retrieval/subsample.py`.  The retrieval
post-processing of `obtain_KNNs` (datasets/dataset_7Scenes_multi.py:198-264):

  1. rank database frames by descending cosine similarity;
  2. drop invalid candidates (the query itself, tombstoned or padded slots);
  3. randomly drop each surviving candidate with p=0.5;
  4. keep every `sampling_period`-th of the survivors starting at a random
     offset in [0, sampling_period);
  5. take the top `k` of what remains.

`subsample_ranked_numpy` / `rank_and_filter_numpy` are the host-side forms
(numpy, as in the JAX package).  `subsample_neighbors_batch` is the device
form with the exact windowed fast path.  Where it differs from the JAX one:

* **Order is explicit.**  `lax.top_k` and the stable `argsort` break ties
  lower index first; `torch.topk` promises no order among equals.  Ranking
  here goes through `ranked_indices`: each (key, index) pair becomes one
  int64 that sorts like the pair, so no two entries are equal and every
  top-k and sort is lower-index-first by construction (equal
  similarities, such as duplicate frames get wherever the GEMM scores
  equal rows alike).
* **Draws are counter-based.**  `jax.random` bits cannot be reproduced, so
  drawing is split from selecting.  `select_ranked_batch` is the
  deterministic core and takes the drop bits and start offsets as inputs
  (the parity tests feed it the bits the JAX functions drew).  The port's
  own draws hash (seed, query row, rank column) to 32 bits: the bit for
  rank position r of query b does not depend on how many columns are
  drawn, so results are identical for every `candidates` value including
  None, which the JAX package gets from fixed 256-wide chunks.
* **The window fallback** (`lax.cond(all(win_ok))`) is a host read of one
  boolean per batch, a synchronisation point of the query step (span
  `select.window_read`; the fallback's full sort is span
  `select.full_sort`, utils/profiling.py).  `WINDOW_CALLS` and
  `WINDOW_FALLBACKS` count the windowed batches and those that fell
  back.
"""

from __future__ import annotations

import numpy as np
import torch

from relpose_gnn_tpu_torch import require_full_fp32
from relpose_gnn_tpu_torch.utils.profiling import span

_M32 = 0xFFFFFFFF

# Batches that took the windowed path so far in this process, and those
# of them whose window could not fill k selections and fell back to the
# full sort.  A run reads both before and after the batches it serves.
WINDOW_CALLS = 0
WINDOW_FALLBACKS = 0


# The table's similarities are computed in blocks of this many rows, so
# that no value's sum depends on how many rows the table has: cuBLAS picks
# its reduction order (split-K) by the output's shape, which moved values
# by up to 5e-6 relative between a 2048-row table and its halves on the
# H100, enough to reorder near-ties.  A table sharded over ranks
# (parallel/sharded_db.py) then ranks by the very values the whole table
# gives, wherever its rows per rank are a multiple of the block.
SIM_BLOCK = 512


def similarities(q_desc: torch.Tensor,
                 db_desc: torch.Tensor) -> torch.Tensor:
    """[B, Dv] x [M, Dv] -> float32 [B, M].  The table is float32 or
    bfloat16 (the service's rank_dtype) and the query is cast to it; products accumulate in float32 and come
    out in float32 (a bfloat16 GEMM that rounded its output to bfloat16
    would erase the ranking).  On the card that is
    `mm(..., out_dtype=float32)`, which reads the table as it is stored;
    the CPU has no such GEMM, so there both operands are widened first,
    which gives the same products and sums.  One product per SIM_BLOCK
    rows of the table.  Every index of the port scores its table so
    (the service, `NetVLADIndex`, `VLADIndex`); a float32 table refuses
    TF32 (`require_full_fp32`)."""
    require_full_fp32(db_desc)
    q = q_desc.to(db_desc.dtype)

    def block(t):
        if t.dtype == torch.float32:
            return q @ t.T
        if t.device.type == "cuda":
            return torch.mm(q, t.T, out_dtype=torch.float32)
        return q.float() @ t.float().T

    return torch.cat([block(db_desc[i:i + SIM_BLOCK])
                      for i in range(0, db_desc.shape[0], SIM_BLOCK)], 1)


def subsample_ranked_numpy(sorted_indices: np.ndarray, k: int,
                           sampling_period: int,
                           rng: np.random.Generator) -> np.ndarray:
    """Steps 3-5 on an already-ranked, already-filtered index list."""
    survive = rng.random(sorted_indices.shape[0]) < 0.5
    kept = sorted_indices[survive]
    start = int(rng.integers(0, sampling_period))
    strided = kept[start::sampling_period]
    return strided[:k]


def rank_and_filter_numpy(similarity: np.ndarray,
                          invalid: np.ndarray | None = None) -> np.ndarray:
    """Steps 1-2: descending-similarity ranking with invalid entries removed.

    `invalid`: bool mask over database entries (True = excluded)."""
    order = np.argsort(1.0 - similarity, kind="stable")
    if invalid is not None:
        order = order[~invalid[order]]
    return order


# ---------------------------------------------------------------------------
# Explicit order
# ---------------------------------------------------------------------------


def ranked_indices(key: torch.Tensor, c: int | None = None) -> torch.Tensor:
    """Indices of the `c` smallest entries of float32 `key` [..., M] along
    the last axis (all of them when `c` is None), in ascending key order,
    equal keys lower index first; +inf keys rank last.  int64 [..., c].

    Each float maps to the int32 that orders like it (the IEEE bit pattern,
    magnitude bits flipped for negatives; -0.0 is first made +0.0), and
    `(that << 32) | index` is one int64 per entry that sorts like the
    (key, index) pair.  All are distinct, so `topk` and `sort` have no
    ties to break."""
    if key.dtype != torch.float32:
        raise TypeError(f"ranked_indices: key is {key.dtype}, want float32")
    m = key.shape[-1]
    bits = (key + 0.0).contiguous().view(torch.int32)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    idx = torch.arange(m, dtype=torch.int64, device=key.device)
    composite = (ordered << 32) | idx
    if c is None or c >= m:
        picked = torch.sort(composite, dim=-1).values
    else:
        picked = torch.topk(composite, c, dim=-1, largest=False,
                            sorted=True).values
    return picked & _M32


# ---------------------------------------------------------------------------
# Counter-based draws
# ---------------------------------------------------------------------------


def _fmix32(x):
    """murmur3's 32-bit finaliser on values held in int64 (tensors or
    Python ints); every product is masked to 32 bits before a shift."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def fold_in(seed: int, i: int) -> int:
    """A new seed from (seed, i): the per-batch seed of a query stream."""
    x = (int(seed) * 0x9E3779B1 + int(i) * 0x85EBCA77 + 0x165667B1) & _M32
    return int(_fmix32(_fmix32(x) ^ ((int(seed) >> 32) & _M32)))


def _hash_bits(seed: int, rows: torch.Tensor, cols: torch.Tensor,
               stream: int) -> torch.Tensor:
    """32 pseudo-random bits per (row, col), as int64 in [0, 2^32): a
    function of (seed, stream, row, col) alone."""
    s = _fmix32((int(seed) & _M32) ^ (stream * 0x27D4EB2F & _M32))
    x = (rows * 0x9E3779B1 + s) & _M32
    x = _fmix32(x)
    x = (x ^ (cols * 0x85EBCA77 & _M32)) & _M32
    return _fmix32(_fmix32(x) ^ ((int(seed) >> 32) & _M32))


def draw_survive_bits(seed: int, b: int, n: int,
                      device: torch.device | str, row0: int = 0
                      ) -> torch.Tensor:
    """Bernoulli(0.5) keep mask [b, n] of query rows [row0, row0 + b):
    entry (i, r) depends on (seed, row0 + i, r) only, so any prefix of
    columns is the same whatever `n` is, and a batch split into row
    blocks draws what the whole batch draws."""
    rows = torch.arange(row0, row0 + b, dtype=torch.int64,
                        device=device)[:, None]
    cols = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    return (_hash_bits(seed, rows, cols, stream=1) >> 31) == 0


def draw_starts(seed: int, b: int, sampling_period: int,
                device: torch.device | str, row0: int = 0) -> torch.Tensor:
    """Stride offsets [b] in [0, sampling_period) of query rows [row0,
    row0 + b) (32 hashed bits modulo the period: the bias is under
    period / 2^32)."""
    rows = torch.arange(row0, row0 + b, dtype=torch.int64, device=device)
    zero = torch.zeros_like(rows)
    return _hash_bits(seed, rows, zero, stream=2) % sampling_period


# ---------------------------------------------------------------------------
# Selection
# ---------------------------------------------------------------------------


def select_ranked_batch(order: torch.Tensor, inv_sorted: torch.Tensor,
                        survive_bits: torch.Tensor, starts: torch.Tensor,
                        k: int, sampling_period: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched steps 3-5 on ranked windows: order / inv_sorted /
    survive_bits [B, C], starts [B] -> (idx [B, k], enough [B]).

    `enough` says the window supplied k true selections.  Where it did
    not, the tail repeats the best selected candidate; with no survivor at
    all, the best-ranked valid one (rank 0 may be an excluded entry and
    must never fill the graph)."""
    c = order.shape[1]
    survive = survive_bits & ~inv_sorted
    pos = torch.cumsum(survive.to(torch.int64), dim=1) - 1
    st = starts.to(torch.int64)[:, None]
    selected = survive & ((pos - st) % sampling_period == 0) & (pos >= st)
    # the first k selected in rank order: selected entries score their
    # rank, the others rank + c, all distinct
    ar = torch.arange(c, dtype=torch.int64, device=order.device)
    score = torch.where(selected, ar, ar + c)
    take = torch.topk(score, min(k, c), dim=1, largest=False,
                      sorted=True).indices
    if c < k:   # a window shorter than k: pad with rank 0, clamped below
        take = torch.cat([take, take.new_zeros(take.shape[0], k - c)], 1)
    enough = torch.sum(selected, dim=1) >= k
    any_sel = torch.any(selected, dim=1, keepdim=True)
    # argmax returns the first maximal index: the first True
    first_sel = torch.argmax(selected.to(torch.int8), dim=1, keepdim=True)
    first_valid = torch.argmax((~inv_sorted).to(torch.int8), dim=1,
                               keepdim=True)
    take = torch.where(torch.gather(selected, 1, take), take,
                       torch.where(any_sel, first_sel, first_valid))
    return torch.gather(order, 1, take), enough


def subsample_neighbors_batch(seed: int, similarity: torch.Tensor,
                              invalid: torch.Tensor, k: int,
                              sampling_period: int,
                              candidates: int | None = None,
                              row0: int = 0) -> torch.Tensor:
    """similarity [B, M] float32, invalid [M] or [B, M] bool -> neighbor
    indices int64 [B, k], on the similarity's device.

    `candidates` enables the windowed fast path: per query only the
    top-`candidates` ranked entries are considered (a top-k instead of a
    full sort of M).  It is exact: invalid entries rank last in both
    branches, the drop bits are keyed by rank position, and if any query
    cannot fill k selections inside its window the whole batch is
    recomputed with the full sort.  Results are identical for every
    `candidates` value, None included, for the same seed.  The rows are
    rows [row0, row0 + B) of a larger batch for the draws: a batch split
    into blocks selects what the whole batch selects."""
    global WINDOW_CALLS, WINDOW_FALLBACKS
    b, m = similarity.shape
    if candidates is not None and candidates < 1:
        raise ValueError(f"candidates must be >= 1 or None, got {candidates}")
    dev = similarity.device
    invalid = invalid.expand(b, m)
    starts = draw_starts(seed, b, sampling_period, dev, row0)
    inf = torch.full_like(similarity, float("inf"))
    key = torch.where(invalid, inf, 1.0 - similarity)

    def select(c):
        order = ranked_indices(key, c)
        return select_ranked_batch(
            order, torch.gather(invalid, 1, order),
            draw_survive_bits(seed, b, order.shape[1], dev, row0), starts,
            k, sampling_period)

    if candidates is None or candidates >= m:
        return select(None)[0]
    WINDOW_CALLS += 1
    win_idx, win_ok = select(min(m, max(int(candidates), k)))
    with span("select.window_read"):
        filled = bool(win_ok.all())     # host read: one boolean per batch
    if filled:
        return win_idx
    WINDOW_FALLBACKS += 1
    with span("select.full_sort"):
        return select(None)[0]


def subsample_neighbors(seed: int, similarity: torch.Tensor,
                        invalid: torch.Tensor, k: int,
                        sampling_period: int) -> torch.Tensor:
    """One query: similarity [M] + invalid mask [M] -> idx [k] (the batch
    form on a batch of one, full sort).  Static output shape: if fewer
    than `k` candidates survive, the tail repeats the best survivor."""
    return subsample_neighbors_batch(seed, similarity[None], invalid[None],
                                     k, sampling_period)[0]


def cosine_topk(db: torch.Tensor, queries: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain batched cosine top-k: one full-float32 matrix product and a
    lower-index-first top-k.  db [M, D], queries [Q, D], both
    L2-normalised -> (scores [Q, k], indices [Q, k])."""
    sim = queries.float() @ db.float().T
    idx = ranked_indices(-sim, k)
    return torch.gather(sim, 1, idx), idx
