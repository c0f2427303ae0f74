"""Sharded serving database: capacity over several GPUs.

Port of `relpose_gnn_tpu/parallel/sharded_db.py`.  NetVLAD descriptors
are [M, 32768] float32 = 128 KB a frame and backbone embeddings [M, D] up
to 8 KB a frame: a replicated table caps M at one card's memory, so
several cards bought throughput only.  Sharding the two big tables over a
mesh axis buys capacity and keeps retrieval exact.  Reference cost being
scaled: dataset_7Scenes_multi.py:240-243 (the cosine-similarity ranking
over the whole scene database).

Design (the tables never move):

  * `desc` and `emb` split dim 0 (M) over the axis: rank i holds rows
    [i M / n, (i + 1) M / n); `poses` [M, 6] and `valid` [M] stay whole on
    every rank (25 B a frame).
  * retrieval: each rank ranks its own [B, M / n] similarities and keeps
    its top C with GLOBAL indices; the short candidate lists ([n, B, C]
    values and indices) are gathered, and every rank merges them the same
    way into the top-W window, then runs the dense path's deterministic
    or stochastic selection on it.  The merge is identical on every rank,
    so the selection needs no broadcast.
  * embedding lookup: each rank gathers the selected rows it owns, zeros
    elsewhere, and one all-reduce (sum) stitches [B, K, D].

Exactness against the replicated layout (tests/test_torch_sharded_db.py):

  * each similarity is computed whole on one rank, in the table's
    rank_dtype with float32 accumulation, as the replicated path does,
    and by the same GEMM: `retrieval/subsample.py::similarities` multiplies
    in blocks of SIM_BLOCK table rows, so with M / n a multiple of the
    block a rank's values are the whole table's bit for bit (cuBLAS sums
    in another order for another output shape);
  * both modes rank by the replicated path's own ascending key: `-sim`
    in deterministic mode, `1 - sim` in stochastic mode (the two are not
    interchangeable in floats), +inf on invalid rows.  `ranked_indices`
    orders equal keys lower index first; the gathered list is rank-major
    and rank-local order minor, so on equal keys position order IS global
    index order, and the merge reproduces the dense tie rule;
  * the candidate values move by gather, never by a sum, which would turn
    a -0.0 into +0.0;
  * the stochastic drop bits and stride starts are the dense path's
    counter-based draws (retrieval/subsample.py), keyed by (seed, query
    row, rank position) and so the same whatever the window's width;
    the window is the JAX dense path's chunk-rounded one.  Wherever the
    window holds k selections the result is the replicated path's.  The
    replicated path's full-sort fallback does not exist here (a
    distributed full sort is not worth P[shortfall] ~ 1e-31 a query at
    256 candidates); on a shortfall the window's clamp applies (the tail
    repeats the best selected candidate).  `retrieval_candidates` is
    therefore required in stochastic mode.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from relpose_gnn_tpu_torch.parallel.mesh import (axis_group, axis_rank,
                                                 axis_size)
from relpose_gnn_tpu_torch.parallel.multihost import all_gather_blocks
from relpose_gnn_tpu_torch.retrieval.subsample import (draw_starts,
                                                       draw_survive_bits,
                                                       ranked_indices,
                                                       select_ranked_batch,
                                                       similarities)

# the JAX dense path draws its stochastic drop bits in chunks of this many
# rank positions and windows the candidates to whole chunks
MASK_CHUNK = 256


def stochastic_window(m: int, k: int, candidates: int) -> int:
    """The JAX dense windowed path's chunk-rounded candidate window."""
    return min(m, ((max(int(candidates), k) + MASK_CHUNK - 1)
                   // MASK_CHUNK) * MASK_CHUNK)


def select_and_lookup(q_desc: torch.Tensor, desc: torch.Tensor,
                      emb: torch.Tensor, valid: torch.Tensor, *, mesh,
                      axis: str, k: int, sampling_period: int,
                      deterministic: bool, candidates: int | None,
                      seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Neighbour selection and embedding lookup against sharded tables.

    q_desc [B, Dv] (whole on every rank), desc [M / n, Dv] and emb
    [M / n, D] (this rank's rows), valid [M] (whole).  Returns (nbrs
    [B, k] int64 global indices, nbr_emb [B, k, D]), equal on every rank.
    The selection is the replicated service's, mode by mode (module
    docstring); `seed` keys the stochastic draws."""
    b = q_desc.shape[0]
    n = axis_size(mesh, axis)
    m_l = desc.shape[0]
    m = m_l * n
    if valid.shape[0] != m:
        raise ValueError(f"sharded database: valid has {valid.shape[0]} "
                         f"rows for {n} shards of {m_l}")
    if deterministic:
        window = min((k - 1) * sampling_period + 1, m)
    else:
        if candidates is None:
            raise ValueError(
                "sharded-database stochastic retrieval requires "
                "ServiceConfig.retrieval_candidates (a full-M sort would "
                "gather the sharded tables)")
        window = stochastic_window(m, k, candidates)
    c_l = min(window, m_l)
    group, i = axis_group(mesh, axis), axis_rank(mesh, axis)
    lo = i * m_l

    sim = similarities(q_desc, desc)                      # [B, m_l] f32
    valid_l = valid[lo:lo + m_l]
    inf = torch.full_like(sim, float("inf"))
    key = torch.where(valid_l[None, :],
                      -sim if deterministic else 1.0 - sim, inf)
    loc = ranked_indices(key, c_l)                        # [B, c_l]
    key_l = torch.gather(key, 1, loc)
    # the short candidate lists move, the tables do not: [n, B, c_l]
    keys = all_gather_blocks(key_l, group)
    gidx = all_gather_blocks(loc + lo, group)
    keys = keys.permute(1, 0, 2).reshape(b, n * c_l)
    gidx = gidx.permute(1, 0, 2).reshape(b, n * c_l)
    pos = ranked_indices(keys, window)                    # [B, W]
    order = torch.gather(gidx, 1, pos)

    if deterministic:
        n_valid = torch.sum(valid.to(torch.int64))
        ranks = torch.arange(k, dtype=torch.int64,
                             device=sim.device) * sampling_period
        ranks = torch.minimum(ranks, torch.clamp_min(n_valid - 1, 0))
        ranks = torch.clamp_max(ranks, window - 1)
        nbrs = order[:, ranks]
    else:
        inv_sorted = torch.isinf(torch.gather(keys, 1, pos))
        nbrs, _ = select_ranked_batch(
            order, inv_sorted, draw_survive_bits(seed, b, window,
                                                 sim.device),
            draw_starts(seed, b, sampling_period, sim.device), k,
            sampling_period)

    # sharded table lookup: exactly one rank owns each row; the sum adds
    # zeros elsewhere
    loc_k = nbrs - lo
    owned = (loc_k >= 0) & (loc_k < m_l)
    rows = emb[torch.clamp(loc_k, 0, m_l - 1)]
    rows = torch.where(owned[..., None], rows, torch.zeros_like(rows))
    if group is not None and n > 1:
        dist.all_reduce(rows, group=group)
    return nbrs, rows
