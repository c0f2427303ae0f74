"""Training's reference: the masked homoscedastic L1 over the kNN edges,
dropout after the GNN, and Adam, plainly.

    loss = exp(-srx) |t - t*|_1 + srx + exp(-srq) |q - q*|_1 + srq

means over the edges of the dynamic kNN graph, the relative targets
`p_s - p_t` of each edge (s -> t).  Dropout follows the program's stated
draw protocol: keep with probability 1 - rate, from a generator seeded by
`fold_in(fold_in(seed, step), 0)` on the card, first over the node
features [B, N, D], then over the dense grid of edge features
[B, N, N, D] (of which the graph's edges are read).  The graph is the
dynamic kNN one, or one given: the check follows the program's own graph
(`adj`) and judges that graph apart (`graph_gap`), since bfloat16 and
float32 order near-equal distances differently.  Adam with L2 weight
decay as torch states it.  BatchNorm normalises with the batch's
statistics.
"""

from __future__ import annotations

import torch

from portbench.reference import nets
from portbench.reference.selection import fold_in


def dropout_fn(seed: int, step: int, rate: float, device):
    """`drop(x, e)` of train step `step` (its masks drawn as above)."""
    gen = torch.Generator(device=device).manual_seed(
        fold_in(fold_in(seed, step), 0))
    keep = 1.0 - rate

    def drop(x, e):
        b, n, d = x.shape
        kx = torch.rand((b, n, d), generator=gen, device=device) < keep
        ke = torch.rand((b, n, n, e.shape[-1]), generator=gen,
                        device=device) < keep
        src, tgt = drop.edges
        ke = ke[torch.arange(b, device=device)[:, None], src, tgt]
        return (torch.where(kx, x / keep, torch.zeros_like(x)),
                torch.where(ke, e / keep, torch.zeros_like(e)))

    return drop


def loss(sd, crit, m, images, poses, prec, drop=None, adj=None):
    """Training forward and loss over a batch: images [B, N, H, W, 3]
    normalised, poses [B, N, 6]; the graph is the kNN one of the batch's
    embeddings, or `adj` [B, N, N] where given.  Returns (loss, data term,
    the embeddings, the graph's (src, tgt) or None where `adj` is not a
    kNN-k graph)."""
    b, n = images.shape[:2]
    x = nets.encode(sd, m, images.reshape((b * n,) + images.shape[2:]), prec,
                    train=True).reshape(b, n, -1)
    if adj is None:
        edges = nets.knn(x.detach(), m["knn"])[:2]
    else:
        edges = nets.edges_of(adj, m["knn"])
        if edges is None:
            return None, None, x, None
    if drop is not None:
        drop.edges = edges
    pred, src, tgt, _ = nets.relpose_edges(sd, m, x, prec, drop=drop,
                                           edges=edges)
    rows = torch.arange(b, device=x.device)[:, None]
    target = poses[rows, src] - poses[rows, tgt]
    t = (pred[..., :3] - target[..., :3]).abs().mean()
    q = (pred[..., 3:] - target[..., 3:]).abs().mean()
    data = torch.exp(-crit["srx"]) * t + torch.exp(-crit["srq"]) * q
    return data + crit["srx"] + crit["srq"], data, x, edges


def adjacency(edges, n: int):
    """(src, tgt) [B, E] -> adj [B, N, N] bool."""
    src, tgt = edges
    b = src.shape[0]
    adj = torch.zeros(b, n, n, dtype=torch.bool, device=src.device)
    adj[torch.arange(b, device=src.device)[:, None], src, tgt] = True
    return adj


def graph_gap(x, adj, k: int) -> float:
    """How far graph `adj` is from the kNN-k graph of embeddings x: over
    every target, the largest excess of a chosen source's distance over
    the k-th smallest distance, relative to it (0 where the graph is the
    kNN graph; a near-tie swapped reads the tie's width)."""
    b, n, _ = x.shape
    d = nets.sq_dists(x.detach())
    d = torch.where(torch.eye(n, dtype=torch.bool, device=x.device),
                    torch.full_like(d, float("inf")), d)
    kth = torch.sort(d, dim=1).values[:, k - 1]             # [B, t]
    chosen = torch.where(adj, d, torch.zeros_like(d)).amax(1)
    return float(((chosen - kth) / kth.clamp_min(1e-30)).clamp_min(0).max())


class Adam:
    """torch's Adam with L2 weight decay: g += wd p, then the moments with
    bias correction."""

    def __init__(self, params: dict, lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.p, self.lr, self.wd = params, lr, weight_decay
        self.b1, self.b2, self.eps = betas[0], betas[1], eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.p.items():
            g = grads[k] + self.wd * p
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k].sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)
