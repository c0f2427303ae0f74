"""Whether the served answers are right, judged by the reference.

The served path's answer to a query is its 7 neighbours, its anchor node
and its pose.  With random weights bfloat16 and float32 can order two
nearly equal candidates differently, so each stage is judged on the same
inputs (`judge`):

* retrieval: the reference ranks the database by its own float32
  descriptors and selects with the same draws.  `retrieval_gap` is the
  widest gap, over the sampled queries and the 7 slots, between the
  reference similarity of the served neighbour and of the reference's own
  neighbour in that slot, over the spread of the query's top-C window.  A
  near-tie swapped reads a small fraction; a wrong neighbour reads ~1.
* graph and pose: given the served neighbours and the served anchor
  node, the reference encodes the query and those database frames,
  builds the kNN graph, runs the GNN and recovers the pose from that
  anchor as the program states it (`anchor - pred_rel[anchor, query]`).
  `pose_gap` is the widest difference of a served pose from the
  reference's, over the RMS of the reference's relative poses.  Where the
  served anchor is no kNN source of the query in the reference's graph,
  the reference's pose is its own anchor's.  A query whose kNN sets of
  the query or the anchor (all that the anchor's edge reads) are within
  `tie_margin` of a tie in the reference's own distances is not compared
  (counted in `tie_share`): the reference alone decides which.
* anchor: `anchor_gap` is how far the served anchor is from the
  reference's nearest neighbour of the query: the widest excess of its
  distance over the nearest one, relative (bfloat16 reorders near-equal
  distances of random-weight embeddings by a few hundredths).

The reference never reads what the program made: it rebuilds the tables
from the same frames, with the same weights, and works the draws out
again.  `serve` runs the reference in the program's place (the control,
in a lower precision).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import nets, selection


class ServeInputs:
    """What both sides get: weights, database frames and poses, the pool
    of query batches, the scene's normalisation and the stream's seed."""

    def __init__(self, config: dict, traffic: dict, pose_w: dict,
                 netvlad_w: dict | None, db_frames: np.ndarray,
                 db_poses: np.ndarray, pool: np.ndarray, mean, std,
                 stream_seed: int, device):
        self.m, self.r, self.t = config["model"], config.get(
            "retrieval"), traffic
        self.pose_w, self.netvlad_w = pose_w, netvlad_w
        self.db_frames, self.db_poses, self.pool = db_frames, db_poses, pool
        self.mean = torch.as_tensor(mean, device=device)
        self.std = torch.as_tensor(std, device=device)
        self.stream_seed, self.device = stream_seed, device
        self.batch = traffic["batch"]

    def query_batch(self, i: int) -> np.ndarray:
        """Batch i of the stream: pool batch i mod the pool's size."""
        n = len(self.pool) // self.batch
        j = i % n
        return self.pool[j * self.batch:(j + 1) * self.batch]

    def to01(self, frames: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(frames, device=self.device).float() / 255.0

    def norm(self, x01: torch.Tensor) -> torch.Tensor:
        return (x01 - self.mean) / self.std


class Reference:
    """The reference's tables and encoders at one precision."""

    def __init__(self, inp: ServeInputs, prec: nets.Precision,
                 chunk: int = 128):
        self.inp, self.prec, self.chunk = inp, prec, chunk
        self._emb: dict = {}
        with torch.no_grad():
            self.table = torch.cat([
                self.descriptor(inp.to01(inp.db_frames[i:i + chunk]))
                for i in range(0, len(inp.db_frames), chunk)])
        self.valid = torch.ones(len(self.table), dtype=torch.bool,
                                device=inp.device)

    @torch.no_grad()
    def encode(self, x01: torch.Tensor) -> torch.Tensor:
        return nets.encode(self.inp.pose_w, self.inp.m, self.inp.norm(x01),
                           self.prec)

    @torch.no_grad()
    def descriptor(self, x01: torch.Tensor) -> torch.Tensor:
        inp = self.inp
        if inp.t["retrieval"] == "shared-trunk":
            e = self.encode(x01)
            return e / e.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return nets.netvlad(inp.netvlad_w, inp.r,
                            nets.netvlad_input(x01, inp.r["retrieval_hw"]),
                            self.prec)

    @torch.no_grad()
    def db_embeddings(self, rows: torch.Tensor) -> torch.Tensor:
        """Embeddings of database rows `rows` (any shape), computed once
        each."""
        flat = rows.reshape(-1).tolist()
        todo = sorted({r for r in flat if r not in self._emb})
        for i in range(0, len(todo), self.chunk):
            part = todo[i:i + self.chunk]
            emb = self.encode(self.inp.to01(self.inp.db_frames[part]))
            self._emb.update(zip(part, emb))
        return torch.stack([self._emb[r] for r in flat]).reshape(
            *rows.shape, -1)

    @torch.no_grad()
    def similarities(self, q01: torch.Tensor) -> torch.Tensor:
        return self.descriptor(q01) @ self.table.T

    def select(self, sim: torch.Tensor, i: int) -> torch.Tensor:
        t = self.inp.t
        return selection.select(sim, self.valid, self.inp.m["num_nodes"] - 1,
                                t["sampling_period"],
                                selection.fold_in(self.inp.stream_seed, i),
                                t["deterministic"])

    @torch.no_grad()
    def graph(self, q01: torch.Tensor, nbrs: torch.Tensor,
              anchor: torch.Tensor | None = None) -> dict:
        """The GNN over [query | database rows `nbrs`] and the pose from
        the anchor node: the reference's own nearest neighbour of the
        query, or `anchor` (the served one) where given."""
        x = torch.cat([self.encode(q01)[:, None], self.db_embeddings(nbrs)],
                      1)
        pred, src, _, margin = nets.relpose_edges(self.inp.pose_w,
                                                  self.inp.m, x, self.prec)
        own, _ = nets.nearest(x, 0)
        a = own if anchor is None else anchor
        rows = torch.arange(len(a), device=x.device)
        k = self.inp.m["knn"]
        hit = src[:, :k] == a[:, None]      # the edge a -> query, if any
        d = nets.sq_dists(x)[:, 0]
        d[:, 0] = float("inf")
        best = d.amin(1).clamp_min(1e-30)
        anchor_gap = (d[rows, a] - best) / best
        # no such edge: the pose from the reference's own anchor, whose
        # edge is always the query's first
        a = torch.where(hit.any(1), a, own)
        rel = pred[rows, hit.to(torch.int8).argmax(1)]
        poses = torch.as_tensor(self.inp.db_poses, device=x.device)
        return {"pose": poses[nbrs[rows, a - 1]] - rel, "anchor": own,
                "rel": rel, "anchor_gap": anchor_gap,
                # the anchor's edge reads the kNN sets of the query and
                # the anchor (through the first pass's messages) only
                "tie_margin": torch.minimum(margin[:, 0], margin[rows, a])}


def serve(inp: ServeInputs, batches, prec: nets.Precision) -> dict:
    """The reference in the program's place: {i: answers of batch i}."""
    ref = Reference(inp, prec)
    out = {}
    for i in batches:
        q01 = inp.to01(inp.query_batch(i))
        nbrs = ref.select(ref.similarities(q01), i)
        g = ref.graph(q01, nbrs)
        out[i] = {"pose": g["pose"].cpu().numpy(),
                  "neighbors": nbrs.cpu().numpy(),
                  "anchor": g["anchor"].cpu().numpy()}
    return out


def judge(inp: ServeInputs, answers: dict, tie_margin: float) -> dict:
    """The numbers compared, over the batches in `answers` ({i: {"pose",
    "neighbors", "anchor"} as numpy}), and what they were read over."""
    ref = Reference(inp, nets.Precision("float32"))
    m_live = len(ref.table)
    window = inp.t["retrieval_candidates"] or m_live
    gaps, errs, rels, ties, flips, agaps = [], [], [], [], [], []
    for i, ans in answers.items():
        q01 = inp.to01(inp.query_batch(i))
        sim = ref.similarities(q01)
        own = ref.select(sim, i)
        served = torch.as_tensor(ans["neighbors"], device=inp.device,
                                 dtype=torch.int64)
        bad = (served < 0) | (served >= m_live)
        served = served.clamp(0, m_live - 1)
        n = inp.m["num_nodes"]
        anchor = torch.as_tensor(ans["anchor"], device=inp.device,
                                 dtype=torch.int64)
        bad_anchor = (anchor < 1) | (anchor >= n)
        top = torch.sort(sim, dim=1, descending=True).values
        spread = (top[:, 0] - top[:, min(window, m_live) - 1]).clamp_min(
            1e-30)
        gap = (sim.gather(1, served) - sim.gather(1, own)).abs() / spread[
            :, None]
        gaps.append(torch.where(bad, torch.full_like(gap, float("inf")),
                                gap).amax(1))
        g = ref.graph(q01, served, anchor.clamp(1, n - 1))
        pose = torch.as_tensor(ans["pose"], device=inp.device,
                               dtype=torch.float32)
        err = (pose - g["pose"]).abs().amax(1)
        wrong = ~torch.isfinite(err) | bad_anchor
        errs.append(torch.where(wrong, torch.full_like(err, float("inf")),
                                err))
        rels.append(g["rel"])
        ties.append(g["tie_margin"] < tie_margin)
        flips.append(anchor != g["anchor"])
        agaps.append(torch.where(bad_anchor, torch.full_like(
            g["anchor_gap"], float("inf")), g["anchor_gap"]))
    gap, err, tie = torch.cat(gaps), torch.cat(errs), torch.cat(ties)
    scale = torch.cat(rels).pow(2).mean().sqrt().clamp_min(1e-30)
    compared = ~tie
    pose_gap = (float((err[compared] / scale).max()) if compared.any()
                else float("inf"))
    flip = torch.cat(flips)
    return {"retrieval_gap": float(gap.max()), "pose_gap": pose_gap,
            "queries": int(len(gap)), "tie_share": float(tie.float().mean()),
            "pose_gap_all": float((err / scale).max()),
            "anchor_flips": int(flip.sum()),
            "anchor_gap": float(torch.cat(agaps).max())}
