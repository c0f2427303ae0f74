"""The service's neighbour selection rule, plainly (the reference's
`obtain_KNNs` post-processing as the program states it).

Per query: rank the database by descending cosine similarity (ties lower
index first), drop invalid rows, keep each ranked candidate with
probability 1/2, keep every `period`-th survivor from a random start in
[0, period), take the first k.  The draws are the program's stated
protocol: 32 hashed bits of (seed, query row, rank position) for the keep
bit, of (seed, query row) for the start, and a stream of batches seeded by
`fold_in(stream seed, batch index)`.  Deterministic mode takes ranks
0, period, 2 period, ... (clamped to the last valid row).
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _fmix32(x):
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def fold_in(seed: int, i: int) -> int:
    """The seed of batch `i` of a stream seeded `seed`."""
    x = (int(seed) * 0x9E3779B1 + int(i) * 0x85EBCA77 + 0x165667B1) & _M32
    return int(_fmix32(_fmix32(x) ^ ((int(seed) >> 32) & _M32)))


def _bits(seed: int, rows, cols, stream: int):
    s = _fmix32((int(seed) & _M32) ^ (stream * 0x27D4EB2F & _M32))
    x = _fmix32((rows * 0x9E3779B1 + s) & _M32)
    x = (x ^ (cols * 0x85EBCA77 & _M32)) & _M32
    return _fmix32(_fmix32(x) ^ ((int(seed) >> 32) & _M32))


def select(sim: torch.Tensor, valid: torch.Tensor, k: int, period: int,
           seed: int, deterministic: bool = False) -> torch.Tensor:
    """sim [B, M] float32, valid [M] bool -> neighbour rows int64 [B, k]."""
    b, m = sim.shape
    dev = sim.device
    key = torch.where(valid[None, :], 1.0 - sim,
                      torch.full_like(sim, float("inf")))
    order = torch.sort(key, dim=1, stable=True).indices          # [B, M]
    if deterministic:
        n_valid = int(valid.sum())
        ranks = torch.clamp(torch.arange(k, device=dev) * period,
                            max=max(n_valid - 1, 0))
        return order[:, ranks]
    rows = torch.arange(b, dtype=torch.int64, device=dev)
    cols = torch.arange(m, dtype=torch.int64, device=dev)
    keep = (_bits(seed, rows[:, None], cols[None, :], 1) >> 31) == 0
    start = _bits(seed, rows, torch.zeros_like(rows), 2) % period
    keep = keep & valid[order]
    pos = torch.cumsum(keep.to(torch.int64), 1) - 1
    chosen = keep & ((pos - start[:, None]) % period == 0) & (
        pos >= start[:, None])
    out = torch.empty(b, k, dtype=torch.int64, device=dev)
    for i in range(b):
        picks = order[i][chosen[i]][:k]
        if picks.numel() == 0:
            picks = order[i][:1]
        if picks.numel() < k:
            picks = torch.cat([picks, picks[:1].expand(k - picks.numel())])
        out[i] = picks
    return out
