"""End-to-end on-device relocalization service (PyTorch).

Port of `relpose_gnn_tpu/evaluation/service.py`.  One query batch goes

    query image  -> retrieval descriptor              (on device)
                 -> cosine similarities vs the DB      (one matmul)
                 -> strided neighbor subsample
                    (retrieval/subsample.py: deterministic, or
                     rank -> 50% drop -> strided -> top-K)
                 -> gather cached neighbor node embeddings + poses
                 -> dense edge-GNN relative-pose regression
                 -> absolute pose from the nearest-neighbor anchor

State held on device: retrieval descriptors (NetVLAD [M, 32768], or the
L2-normalised backbone embeddings under `retrieval='shared-trunk'`),
backbone node embeddings [M, D], pose6 [M, 6] and a validity mask [M].

What differs from the JAX service, and why:

* Weights live in the modules (`model`, `netvlad`), not in separate
  variable trees, and the service moves them to its `device` (None: the
  CUDA card; it raises where there is none).
* PyTorch runs eagerly: there is no compiled query program, so
  `query_compiles` has no meaning and is not offered, and `capacity` is
  about memory only: tables are allocated once and rows written in place,
  never concatenated (the 32768-wide table is not held twice).
* In-place row writes raise on an out-of-range index where XLA clamps it,
  and the explicit capacity, pose-shape and tombstone-range checks stay
  in front of them all the same.
* The stochastic selection draws from a counter-based generator keyed by
  an integer seed (`rng`), see retrieval/subsample.py.
* The snapshot fingerprint hashes the model's `state_dict` keys, shapes
  and dtypes; a snapshot written by the JAX service fails that check
  loudly.  One without fingerprint keys loads.
* Over several GPUs each process holds its own copy of the service.
  `replicate_over(mesh)` is the throughput form: the weights and the four
  tables are whole on every rank (each rank built them the same), a query
  batch is split over the mesh's data axis, each rank answers its rows
  (its stochastic draws keyed by the GLOBAL query row, so a split batch
  selects what one process selects) and every rank gets the whole result.
  `shard_database(mesh)` is the capacity form: the descriptor and
  embedding tables keep only this rank's rows of M, poses and validity
  stay whole, and the query path ranks and looks up across the ranks
  (parallel/sharded_db.py) with the same results as the replicated
  tables.  Growth, tombstones, compaction and snapshots keep the sharded
  layout: a global row has one owner rank; a snapshot is the replicated
  service's `.npz`, gathered and written by rank 0, and loading one
  re-shards it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
from collections import deque
from typing import Callable, Iterable, Iterator

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.data.pipeline import to_float01
from relpose_gnn_tpu_torch.evaluation.serving import anchored_pose_step
from relpose_gnn_tpu_torch.models.fold_bn import fold_relpose_backbone
from relpose_gnn_tpu_torch.models.netvlad import NetVLADEncoder
from relpose_gnn_tpu_torch.models.posenet import RelPoseGNN
from relpose_gnn_tpu_torch.retrieval.netvlad_index import (IMAGENET_MEAN,
                                                           IMAGENET_STD)
from relpose_gnn_tpu_torch.parallel.mesh import (DATA_AXIS, axis_group,
                                                 axis_rank, axis_size)
from relpose_gnn_tpu_torch.parallel.multihost import (gather_rows, host_read,
                                                      is_main_process)
from relpose_gnn_tpu_torch.parallel.sharded_db import select_and_lookup
from relpose_gnn_tpu_torch.parallel.sharding import batch_rows
from relpose_gnn_tpu_torch.retrieval.subsample import (
    SIM_BLOCK, fold_in, ranked_indices, similarities,
    subsample_neighbors_batch)
from relpose_gnn_tpu_torch.utils.profiling import span

_RANK_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pipelined_stream(query_fn: Callable, batches: Iterable, depth: int,
                      rng: int | None) -> Iterator[dict]:
    """The pipelined-serving schedule: keep up to `depth` batches enqueued
    on the device before the oldest result is fetched to numpy, so batch
    i+1's upload and launches overlap batch i's compute.  Yields one numpy
    result dict per input batch, in order; batch i draws with
    `fold_in(rng, i)`."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    rng = 0 if rng is None else rng
    inflight: deque = deque()

    def fetch(out):
        with span("stream.fetch"):
            return {k: v.cpu().numpy() for k, v in out.items()}

    for i, q in enumerate(batches):
        inflight.append(query_fn(q, fold_in(rng, i)))
        if len(inflight) >= depth:
            yield fetch(inflight.popleft())
    while inflight:
        yield fetch(inflight.popleft())


def _pose_rows(poses, n: int, what: str,
               device: torch.device) -> torch.Tensor:
    """Validate-and-convert a pose batch riding with an n-image batch:
    must be [n, 6] float32.  Short poses would leave valid-marked slots
    holding stale poses; long ones would write past the batch's rows."""
    arr = torch.as_tensor(np.asarray(poses, np.float32), device=device)
    if tuple(arr.shape) != (n, 6):
        raise ValueError(
            f"{what}: poses shape {tuple(arr.shape)} does not match the "
            f"image batch — expected ({n}, 6)")
    return arr


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    """L2-normalize rows in float32 (shared-trunk retrieval descriptors:
    the ranking key's precision does not depend on the compute dtype)."""
    x = x.float()
    n = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp_min(n, 1e-12)


def _model_fingerprint(model: torch.nn.Module) -> tuple[str, float]:
    """(structure md5, value checksum) of a model's state dict.  The
    structure hash (keys + shapes + dtypes) is exact; the value checksum
    is one position-weighted sum of means, reduced on the device.
    Snapshots carry both so that a database embedded under other weights
    or another model config fails loudly at load."""
    sd = model.state_dict()
    desc = ";".join(f"{k}:{tuple(v.shape)}:{v.dtype}" for k, v in sd.items())
    struct = hashlib.md5(desc.encode()).hexdigest()
    s = None
    for i, v in enumerate(sd.values()):
        term = float((i % 13) + 1) * torch.mean(v.float())
        s = term if s is None else s + term
    return struct, float(s)


def _check_fingerprint(z, model: torch.nn.Module, path: str) -> None:
    """Validate a snapshot's model fingerprint against the live weights.
    Snapshots without fingerprint keys skip this (their retrieval and
    resolution guards still apply)."""
    if "model_struct" not in z.files:
        return
    struct, checksum = _model_fingerprint(model)
    if str(z["model_struct"]) != struct:
        raise ValueError(
            f"snapshot {path} was embedded under a model with a DIFFERENT "
            "parameter structure than this service's (wrong backbone / "
            "feat-dim / model config, or a snapshot of the JAX service) — "
            "its cached embeddings are not comparable; rebuild the database")
    if not np.isclose(float(z["model_checksum"]), checksum,
                      rtol=1e-3, atol=1e-5):
        raise ValueError(
            f"snapshot {path} was embedded under different model WEIGHTS "
            f"(checksum {float(z['model_checksum']):.6g} vs live "
            f"{checksum:.6g}) — its cached embeddings (and shared-trunk "
            "descriptors) would silently rank garbage; rebuild the "
            "database with the current weights")


def _check_built_hw(built_hw, q_shape, what: str) -> None:
    """Query images must match the resolution the database was embedded
    at: backbone embeddings at mixed resolutions are not comparable."""
    if built_hw is not None and tuple(q_shape[1:3]) != tuple(built_hw):
        raise ValueError(
            f"{what}: query images are {tuple(q_shape[1:3])} but the "
            f"database was embedded at {tuple(built_hw)} — backbone "
            "embeddings at mixed resolutions are not comparable; rebuild "
            "the database (or resize the queries)")


def _tombstone(valid: torch.Tensor, count: int, indices) -> None:
    """Flip validity bits off for `indices`, in place."""
    idx_np = np.asarray(indices, np.int64).reshape(-1)
    # a stale or typo'd index must not be a silent no-op: the bad frame
    # would keep being served
    if idx_np.size and (idx_np.min() < 0 or idx_np.max() >= count):
        raise ValueError(
            f"invalidate_frames indices out of range [0, {count}): "
            f"{idx_np[(idx_np < 0) | (idx_np >= count)][:8]}")
    valid[torch.as_tensor(idx_np, device=valid.device)] = False


def _compact(desc, emb, poses, valid, count, take=None):
    """Stable front-compaction of a (desc, emb, poses, valid, count)
    database.  Returns the new tensors plus the int64 [M] old_to_new slot
    map (-1 for tombstoned/padded slots).  The row gather allocates a
    full-size destination transiently; `take(table, perm)` gathers the
    descriptor and embedding tables where they are not whole (sharded)."""
    valid_np = valid.cpu().numpy()
    m = valid_np.shape[0]
    n_valid = int(valid_np.sum())
    old_to_new = np.cumsum(valid_np, dtype=np.int64) - 1
    old_to_new[~valid_np] = -1
    if n_valid == count and valid_np[:n_valid].all():
        return desc, emb, poses, valid, count, old_to_new  # already compact
    # stable: valid rows sort first, original order kept within each class
    perm = torch.as_tensor(np.argsort(~valid_np, kind="stable"),
                           device=valid.device)
    new_valid = torch.as_tensor(np.arange(m) < n_valid, device=valid.device)
    take = take or (lambda table, p: table[p])
    return (take(desc, perm), take(emb, perm), poses[perm], new_valid,
            n_valid, old_to_new)


@dataclasses.dataclass
class ServiceConfig:
    """The JAX `ServiceConfig`, field for field with the same defaults."""

    seq_len: int = 8                 # graph size (query + seq_len-1 nbrs)
    sampling_period: int = 5         # neighbor stride
    retrieval_hw: tuple = (192, 256)  # NetVLAD input size
    deterministic: bool = False      # skip the stochastic 50% drop + offset
    retrieval_candidates: int | None = 256
    # ^ windowed neighbor selection: rank only the top-C candidates per
    #   query instead of sorting all M (exact: the batch falls back to the
    #   full sort on window shortfall).  None = always full sort.
    capacity: int | None = None
    # ^ pre-allocated database size for incremental growth (add_frames).
    #   Padded rows are excluded from retrieval by the validity mask on
    #   both selection branches.  None = tables sized exactly to build().
    retrieval: str = "netvlad"
    # ^ "netvlad": a separate VGG16+NetVLAD pass at `retrieval_hw`;
    #   "shared-trunk": rank by cosine over the backbone node embeddings
    #   the GNN consumes (the table is their L2-normalised float32 copy).
    #   A semantic knob: neighbor sets change.
    rank_dtype: str = "float32"
    # ^ descriptor-table dtype for the similarity ranking.  "bfloat16"
    #   halves the table and its read per batch; similarities always
    #   accumulate in float32.  A semantic knob: near-ties can flip.


class RelocalizationService:
    """Device-resident database + the query path."""

    def __init__(self, model: RelPoseGNN, netvlad: NetVLADEncoder | None,
                 cfg: ServiceConfig = ServiceConfig(), fold_bn: bool = True,
                 s2d_stem: bool = False, compact_edges: bool = True,
                 device: torch.device | str | None = None):
        if cfg.retrieval not in ("netvlad", "shared-trunk"):
            raise ValueError(f"unknown retrieval mode {cfg.retrieval!r}: "
                             "expected 'netvlad' or 'shared-trunk'")
        if cfg.rank_dtype not in _RANK_DTYPES:
            raise ValueError(f"unknown rank_dtype {cfg.rank_dtype!r}: "
                             "expected 'float32' or 'bfloat16'")
        self._rank_dt = _RANK_DTYPES[cfg.rank_dtype]
        if cfg.retrieval == "netvlad" and netvlad is None:
            raise ValueError("retrieval='netvlad' needs a NetVLAD encoder "
                             "(pass netvlad, or use "
                             "retrieval='shared-trunk')")
        self.device = resolve_device(device)
        if fold_bn and model.cfg.backbone.startswith("resnet") \
                and not model.cfg.bn_folded:
            # serving form: BN folded into the conv weights; `s2d_stem`
            # also rewrites the stem into its space-to-depth form (the
            # JAX service's A/B knob, off by default)
            _, model = fold_relpose_backbone(model, s2d_stem=s2d_stem)
        if compact_edges and model.cfg.use_gnn \
                and not model.cfg.compact_edges:
            # compact edge-list GNN: pair/attention work on the real kNN
            # edges only; the same parameters
            compact = RelPoseGNN(dataclasses.replace(model.cfg,
                                                     compact_edges=True))
            compact.load_state_dict(model.state_dict(), strict=True)
            model = compact
        self.model = model.to(self.device).eval()
        self.netvlad = (None if netvlad is None
                        else netvlad.to(self.device).eval())
        self.cfg = cfg
        self.db_desc = None   # [M, 32768]
        self.db_emb = None    # [M, D]
        self.db_poses = None  # [M, 6]
        self.db_valid = None  # [M] bool (False = padded/empty slot)
        self.db_count = 0     # rows in use (== M when capacity is None)
        self._model_norm = None  # the normalization build() embedded with
        self._built_hw = None    # (H, W) the database was embedded at
        self._nv_mean = torch.as_tensor(IMAGENET_MEAN, device=self.device)
        self._nv_std = torch.as_tensor(IMAGENET_STD, device=self.device)
        self._mesh = None        # replicate_over / shard_database
        self._db_axis = None     # the axis the tables are sharded over

    # -- database construction ----------------------------------------

    def _require_built(self) -> None:
        if self.db_desc is None:
            raise RuntimeError("the database is empty: call build() or "
                               "load_database() first")

    def _netvlad_input(self, images01: torch.Tensor) -> torch.Tensor:
        """raw [B, H, W, 3] in [0,1] -> NetVLAD input: antialiased,
        half-pixel-centred bilinear resize to `retrieval_hw` on the device
        (the counterpart of `jax.image.resize(..., "bilinear")`; the
        drift between the two is measured in tests/test_torch_service.py),
        then ImageNet normalization."""
        x = F.interpolate(images01.permute(0, 3, 1, 2),
                          size=tuple(self.cfg.retrieval_hw), mode="bilinear",
                          antialias=True, align_corners=False)
        return (x.permute(0, 2, 3, 1) - self._nv_mean) / self._nv_std

    def _to_device01(self, images) -> torch.Tensor:
        """Host (or device) images, uint8 or float in [0, 1] -> float32
        on the device.  uint8 rides the thin transfer and is divided by
        255 there (true division, see `to_float01`), so a uint8 batch
        gives bit for bit what the same batch sent as
        `q.astype(float32) / 255` gives (tested)."""
        with span("service.upload"):
            q = torch.as_tensor(images).to(self.device)
        return to_float01(q) if q.dtype == torch.uint8 else q.float()

    @torch.inference_mode()
    def _embed(self, chunk01: torch.Tensor, model_norm
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(descriptor rows in rank_dtype, embedding rows) of a chunk."""
        emb = self.model.encode_nodes(model_norm(chunk01)[:, None])[:, 0]
        if self.cfg.retrieval == "shared-trunk":
            desc = _unit_rows(emb)
        else:
            desc = self.netvlad(self._netvlad_input(chunk01))
        # the TABLE rounds to rank_dtype once here; queries cast at the
        # matmul and similarities accumulate in float32
        return desc.to(self._rank_dt), emb

    def _write_rows(self, images01, model_norm, batch: int, start: int,
                    desc, emb, rows: int, held: tuple | None = None
                    ) -> tuple:
        """Embed `images01` in chunks under `model_norm` and write them
        into rows [start, start + len) of the tables `desc` and `emb`, in
        place; `held` = (lo, hi) says the tables hold the global rows
        [lo, hi) only (sharded tables), the others are not written.
        Allocates tables of `rows` rows at the first chunk when `desc` is
        None.  Returns (desc, emb)."""
        lo, hi = held or (0, rows)
        for i in range(0, len(images01), batch):
            d, e = self._embed(self._to_device01(images01[i:i + batch]),
                               model_norm)
            if desc is None:
                desc = torch.zeros((rows, d.shape[1]), dtype=d.dtype,
                                   device=self.device)
                emb = torch.zeros((rows, e.shape[1]), dtype=e.dtype,
                                  device=self.device)
            a, b = max(start + i, lo), min(start + i + len(d), hi)
            if a < b:   # global rows [a, b) of this chunk live here
                desc[a - lo:b - lo] = d[a - start - i:b - start - i]
                emb[a - lo:b - lo] = e[a - start - i:b - start - i]
        return desc, emb

    def _own_rows(self) -> tuple[int, int]:
        """The global rows [lo, hi) of the descriptor and embedding
        tables this rank holds (all of them unless sharded)."""
        m = self.db_poses.shape[0]
        if self._db_axis is None:
            return 0, m
        m_l = m // axis_size(self._mesh, self._db_axis)
        lo = axis_rank(self._mesh, self._db_axis) * m_l
        return lo, lo + m_l

    def build(self, db_images01: np.ndarray, db_poses: np.ndarray,
              model_norm, batch: int = 16) -> None:
        """Embed every database frame: retrieval descriptor + backbone
        node embedding.  `model_norm(images01) -> model input` applies the
        scene normalization used at graph-build time (a callable on torch
        tensors).  Accepts float in [0, 1] or uint8 (converted on the
        device per chunk, same contract as query())."""
        m = len(db_images01)
        poses = _pose_rows(db_poses, m, "build", self.device)
        rows = m
        if self.cfg.capacity is not None:
            rows = int(self.cfg.capacity)
            if m > rows:
                raise ValueError(f"database has {m} frames > capacity {rows}")
        self._built_hw = tuple(np.shape(db_images01)[1:3])
        self._model_norm = model_norm
        self.db_poses = torch.zeros((rows, 6), dtype=torch.float32,
                                    device=self.device)
        self.db_poses[:m] = poses
        self.db_desc, self.db_emb = self._write_rows(
            db_images01, model_norm, batch, 0, None, None, rows)
        # rows count as valid only once all of them are embedded
        self.db_valid = torch.arange(rows, device=self.device) < m
        self.db_count = m
        if self._db_axis is not None:
            self._keep_own_rows()

    def add_frames(self, images01: np.ndarray, poses: np.ndarray,
                   model_norm, batch: int = 16) -> None:
        """Grow the database in place: embed `images01` and write them
        into the next free capacity slots.  Requires
        `ServiceConfig.capacity`.  `model_norm` must be the same scene
        normalization build() used."""
        if self.cfg.capacity is None:
            raise ValueError(
                "add_frames requires ServiceConfig.capacity (build() sized "
                "the device tables exactly; there is no free slot to grow "
                "into)")
        self._require_built()
        if self._model_norm is None:
            # database restored via load_database: adopt this call's
            self._model_norm = model_norm
        elif model_norm is not self._model_norm:
            # embedding new frames under a DIFFERENT normalization would
            # silently mix incompatible embeddings
            raise ValueError(
                "add_frames must be called with the same model_norm "
                "function object build() used (a different normalization "
                "requires rebuilding the whole database)")
        _check_built_hw(self._built_hw, np.shape(images01), "add_frames")
        n_new = len(images01)
        cap = int(self.cfg.capacity)
        if self.db_count + n_new > cap:
            raise ValueError(
                f"capacity exceeded: {self.db_count} + {n_new} > {cap}")
        pose_rows = _pose_rows(poses, n_new, "add_frames", self.device)
        self._write_rows(images01, model_norm, batch, self.db_count,
                         self.db_desc, self.db_emb, cap, self._own_rows())
        self.db_poses[self.db_count:self.db_count + n_new] = pose_rows
        self.db_valid[self.db_count:self.db_count + n_new] = True
        self.db_count += n_new

    def invalidate_frames(self, indices) -> None:
        """Tombstone database frames: flips their validity bits so they
        are never retrieved again.  Slots are not reclaimed here:
        add_frames keeps appending to fresh capacity until
        compact_database() reclaims the tombstones."""
        self._require_built()
        _tombstone(self.db_valid, self.db_count, indices)

    def compact_database(self) -> np.ndarray:
        """Reclaim tombstoned slots: permute the valid rows to the front
        (stable: survivors keep their relative order) and reset `db_count`
        to the valid total.

        Returns `old_to_new`, an int64 [M] map from pre-compaction slot
        index to post-compaction index (-1 for tombstoned/padded slots);
        externally held frame indices must be remapped through it.

        Query results are preserved exactly: invalid entries are masked
        out of the ranking key on both selection branches, survivors keep
        their relative order, and drop draws are keyed by rank position,
        so both modes return the same frames (slot indices renumbered
        through `old_to_new`) and identical poses."""
        self._require_built()
        (self.db_desc, self.db_emb, self.db_poses, self.db_valid,
         self.db_count, old_to_new) = _compact(
            self.db_desc, self.db_emb, self.db_poses, self.db_valid,
            self.db_count,
            None if self._db_axis is None else self._take_sharded)
        return old_to_new

    def _take_sharded(self, table: torch.Tensor,
                      perm: torch.Tensor) -> torch.Tensor:
        """`table[perm]` for a table sharded over the ranks: new global
        row g is old row perm[g], on whichever rank owns it.  Each rank's
        block is broadcast in turn and every rank keeps the rows it now
        owns, so no rank ever holds more than two blocks."""
        lo, hi = self._own_rows()
        mine = perm[lo:hi].cpu().numpy()   # old rows of this rank's rows
        group = axis_group(self._mesh, self._db_axis)
        out = torch.empty_like(table)
        for src in range(axis_size(self._mesh, self._db_axis)):
            blk = table.clone()
            dist.broadcast(blk, dist.get_global_rank(group, src),
                           group=group)
            take = np.flatnonzero(mine // (hi - lo) == src)
            if take.size:
                out[torch.as_tensor(take, device=table.device)] = blk[
                    torch.as_tensor(mine[take] - src * (hi - lo),
                                    device=table.device)]
        return out

    # -- database persistence ------------------------------------------

    def save_database(self, path: str) -> None:
        """Persist the built database (descriptors, embeddings, poses,
        validity, count) so a serving restart skips re-embedding the
        scene.  Same `.npz` keys as the JAX service.  bfloat16 tables are
        widened to float32 on disk (npz has no bf16; widening is exact)
        and cast back on load: the round trip is bit-exact."""
        self._require_built()

        def host(x):
            return (x.float() if x.dtype == torch.bfloat16 else x
                    ).cpu().numpy()

        def table(x):   # a sharded table's rows from every rank
            if self._db_axis is None:
                return host(x)
            return host_read(x, self._mesh, self._db_axis)

        def name(dt):
            return str(dt).removeprefix("torch.")

        # bind the snapshot to the weights + input resolution that
        # embedded it
        struct, checksum = _model_fingerprint(self.model)
        desc, emb = table(self.db_desc), table(self.db_emb)
        placed = self._mesh is not None and dist.is_initialized()
        if placed and not is_main_process():   # one copy, rank 0 writes
            dist.barrier()
            return
        np.savez(path, desc=desc, emb=emb,
                 poses=host(self.db_poses), valid=host(self.db_valid),
                 count=np.int64(self.db_count),
                 desc_dtype=name(self.db_desc.dtype),
                 emb_dtype=name(self.db_emb.dtype),
                 retrieval_hw=np.asarray(self.cfg.retrieval_hw, np.int64),
                 retrieval=np.asarray(self.cfg.retrieval),
                 model_struct=np.asarray(struct),
                 model_checksum=np.float64(checksum),
                 built_hw=np.asarray(self._built_hw or (0, 0), np.int64))
        if placed:
            dist.barrier()

    def load_database(self, path: str) -> None:
        """Restore a save_database() snapshot onto the device.  The
        service's config must match the one that built it.  add_frames
        works after a load (it adopts its call's model_norm)."""
        z = np.load(path)
        if "scenes" in z.files:
            raise ValueError(
                f"{path} is a MultiSceneService snapshot (has a 'scenes' "
                "key) — load it through MultiSceneService.load_database, "
                "not the single-scene RelocalizationService")
        if "desc" not in z.files:
            raise ValueError(
                f"{path} is not a RelocalizationService snapshot (keys: "
                f"{sorted(z.files)[:8]})")
        m = z["desc"].shape[0]
        want = self.cfg.capacity if self.cfg.capacity is not None else m
        if m != want:
            raise ValueError(
                f"snapshot rows ({m}) do not match this service's "
                f"capacity ({want}); it was saved under a different "
                "ServiceConfig")
        # descriptors are a function of the retrieval MODE and (for
        # netvlad) the input size; snapshots without a 'retrieval' key
        # were all NetVLAD-built
        snap_mode = (str(z["retrieval"]) if "retrieval" in z.files
                     else "netvlad")
        if snap_mode != self.cfg.retrieval:
            raise ValueError(
                f"snapshot was built with retrieval={snap_mode!r} but this "
                f"service is configured for {self.cfg.retrieval!r}; "
                "descriptors from different retrieval modes are not "
                "comparable — rebuild the database (or match the config)")
        snap_hw = tuple(int(v) for v in z["retrieval_hw"])
        if snap_mode == "netvlad" and snap_hw != tuple(self.cfg.retrieval_hw):
            raise ValueError(
                f"snapshot was built with retrieval_hw={snap_hw} but this "
                f"service embeds queries at {tuple(self.cfg.retrieval_hw)}; "
                "mixed-resolution descriptors are not comparable — rebuild "
                "the database (or match the config)")
        _check_fingerprint(z, self.model, path)
        emb_dt = _RANK_DTYPES.get(str(z["emb_dtype"]))
        if emb_dt is None:
            raise ValueError(f"snapshot emb_dtype {z['emb_dtype']!r} is "
                             "neither float32 nor bfloat16")
        # cast to THIS service's rank_dtype, not the snapshot's: bf16->f32
        # widening is exact, and f32->bf16 equals what a fresh bf16 build
        # would store (embed rounds the same f32 descriptor once)
        dev = self.device
        self.db_desc = torch.as_tensor(z["desc"], device=dev).to(
            self._rank_dt)
        self.db_emb = torch.as_tensor(z["emb"], device=dev).to(emb_dt)
        self.db_poses = torch.as_tensor(z["poses"], device=dev)
        self.db_valid = torch.as_tensor(z["valid"], device=dev)
        self.db_count = int(z["count"])
        self._model_norm = None
        if "built_hw" in z.files and int(z["built_hw"][0]) > 0:
            self._built_hw = tuple(int(v) for v in z["built_hw"])
        if self._db_axis is not None:
            self._keep_own_rows()

    # -- several GPUs --------------------------------------------------

    def replicate_over(self, mesh) -> None:
        """Serve with the weights and the whole database on every rank of
        `mesh`: the THROUGHPUT form (each rank answers its rows of a query
        batch; contrast shard_database, which splits the tables for
        CAPACITY).  Every process built or loaded the same tables, so
        nothing moves here: later queries split their batch over the data
        axis (which it must divide) and gather the results on every
        rank."""
        self._require_built()
        if self._db_axis is not None:
            raise ValueError("database is sharded (shard_database); "
                             "replicate_over is the replicated-DB form")
        self._mesh = mesh

    def shard_database(self, mesh, axis: str | None = None) -> None:
        """Shard the two big tables (desc [M, 32768], emb [M, D]) over a
        mesh axis: several cards buy CAPACITY, not just throughput.  poses
        and valid stay whole (25 B a frame).  The query path switches to
        the sharded retrieval (parallel/sharded_db.py: per-rank top-C,
        candidates gathered, one all-reduce for the lookup).  Neighbours
        and anchors match the replicated tables' exactly where the rows a
        rank holds, M / n, are a multiple of SIM_BLOCK: `similarities`
        then runs the same GEMM shapes on both layouts.  Otherwise the
        card's GEMMs may sum in another order, near-ties may rank
        otherwise, and a warning says so (tests/test_torch_sharded_db.py
        holds the equality on the CPU).

        Call after build()/load_database().  M must divide the axis size;
        stochastic mode requires cfg.retrieval_candidates.  Later
        add_frames / invalidate / compact / load keep the layout."""
        axis = axis or DATA_AXIS
        self._require_built()
        if self._mesh is not None and self._mesh is not mesh:
            raise ValueError("service is already placed over a different "
                             "mesh; build a new service to re-shard")
        m, n = self.db_poses.shape[0], axis_size(mesh, axis)
        if m % n != 0:
            raise ValueError(
                f"database size M={m} must divide mesh axis {axis!r} "
                f"(size {n}); pad cfg.capacity to a multiple")
        if not self.cfg.deterministic and self.cfg.retrieval_candidates \
                is None:
            raise ValueError(
                "sharded-database stochastic retrieval requires "
                "cfg.retrieval_candidates (a full-M sort would gather the "
                "sharded tables)")
        if self._db_axis is not None:
            return
        if self.device.type == "cuda" and (m // n) % SIM_BLOCK:
            logging.getLogger("relpose_gnn_tpu_torch").warning(
                "shard_database: %d rows a rank is no multiple of "
                "SIM_BLOCK=%d, so the GEMMs sum in another order than the "
                "replicated table's and near-ties may rank otherwise",
                m // n, SIM_BLOCK)
        self._mesh, self._db_axis = mesh, axis
        self._keep_own_rows()

    def _keep_own_rows(self) -> None:
        """Cut whole descriptor and embedding tables down to this rank's
        rows."""
        lo, hi = self._own_rows()
        self.db_desc = self.db_desc[lo:hi].clone()
        self.db_emb = self.db_emb[lo:hi].clone()

    # -- the query path, stage by stage ----------------------------------

    def _encode(self, query_model_in: torch.Tensor) -> torch.Tensor:
        """Query backbone embeddings [B, 1, D]."""
        with span("service.encode"):
            return self.model.encode_nodes(query_model_in[:, None])

    def _select(self, sim: torch.Tensor, db_valid: torch.Tensor,
                rng: int, row0: int = 0) -> torch.Tensor:
        """Neighbor selection [B, K] (db_valid masks padding and
        tombstones on both branches); the rows are rows [row0, row0 + B)
        of the query batch for the stochastic draws."""
        cfg = self.cfg
        k = cfg.seq_len - 1
        if not cfg.deterministic:
            return subsample_neighbors_batch(
                rng, sim, ~db_valid, k, cfg.sampling_period,
                candidates=cfg.retrieval_candidates, row0=row0)
        # plain strided top-k: every sampling_period-th of the ranked
        # list.  Only ranks 0..(k-1)*sp are consumed, so rank that window.
        # Ranks clamp to the last VALID entry: with fewer valid frames
        # than the strided window, masked padding would otherwise be
        # selected.
        m = sim.shape[1]
        neg_inf = torch.full_like(sim, float("-inf"))
        sim_m = torch.where(db_valid[None, :], sim, neg_inf)
        c = min((k - 1) * cfg.sampling_period + 1, m)
        order_c = ranked_indices(-sim_m, c)
        n_valid = torch.sum(db_valid.to(torch.int64))
        ranks = torch.arange(k, dtype=torch.int64,
                             device=sim.device) * cfg.sampling_period
        ranks = torch.minimum(ranks, torch.clamp_min(n_valid - 1, 0))
        ranks = torch.clamp_max(ranks, c - 1)   # tiny-DB guard (m < c)
        return order_c[:, ranks]

    @torch.inference_mode()
    def _query_fn(self, model_norm, db: tuple, query01: torch.Tensor,
                  rng: int, norm_ms, row0: int = 0) -> dict:
        cfg = self.cfg
        db_desc, db_emb, db_poses, db_valid = db
        # norm_ms=(mean, std) passes the scene normalization as runtime
        # tensors, applied as (x - mean) * (1/std): the form the JAX
        # service defines for it (its compiler turns the division of a
        # model_norm closure into that product).  model_norm is applied
        # as written.
        if norm_ms is None:
            query_model_in = model_norm(query01)
        else:
            mean, std = (torch.as_tensor(a, dtype=torch.float32,
                                         device=self.device)
                         for a in norm_ms)
            query_model_in = (query01 - mean) * (1.0 / std)
        b = query01.shape[0]
        # 1. retrieval descriptor + similarities (one matmul).
        # shared-trunk reuses the query's backbone embedding as its
        # descriptor
        if cfg.retrieval == "shared-trunk":
            q_emb = self._encode(query_model_in)
            with span("service.descriptor"):
                q_desc = _unit_rows(q_emb[:, 0])
        else:
            q_emb = None
            x = self._netvlad_input(query01)
            with span("service.descriptor"):
                q_desc = self.netvlad(x)
        nbr_emb = None
        if self._db_axis is not None:
            # 2'. sharded tables: per-rank top-C, the candidates gathered,
            # one all-reduce for the embedding lookup
            with span("service.rank"):
                nbrs, nbr_emb = select_and_lookup(
                    q_desc, db_desc, db_emb, db_valid, mesh=self._mesh,
                    axis=self._db_axis, k=cfg.seq_len - 1,
                    sampling_period=cfg.sampling_period,
                    deterministic=cfg.deterministic,
                    candidates=cfg.retrieval_candidates, seed=rng)
        else:
            with span("service.rank"):
                sim = similarities(q_desc, db_desc)
            # 2. neighbor selection
            with span("service.select"):
                nbrs = self._select(sim, db_valid, rng, row0)
        if q_emb is None:
            q_emb = self._encode(query_model_in)
        # 3. graph assembly from cached embeddings
        with span("service.gather"):
            if nbr_emb is None:
                nbr_emb = db_emb[nbrs]
            nbr_poses = db_poses[nbrs]
            adj = torch.as_tensor(~np.eye(cfg.seq_len, dtype=bool),
                                  device=self.device).expand(
                b, cfg.seq_len, cfg.seq_len)
        # 4. GNN + pose recovery
        with span("service.gnn"):
            out = anchored_pose_step(self.model, q_emb, nbr_emb, nbr_poses,
                                     adj)
        return {"pose": out["pred"], "neighbors": nbrs,
                "anchor": out["nbr"]}

    def query(self, query_images01: np.ndarray, model_norm,
              rng: int | None = None, norm_ms=None) -> dict:
        """Relocalize a batch of raw [B, H, W, 3] images.

        Accepts float in [0, 1], or uint8 (a 4x thinner transfer,
        converted on the device; bit-identical to the same values sent as
        quantised floats).  `rng` is the integer seed of the stochastic
        selection (ignored in deterministic mode; None = 0).

        `norm_ms=(mean, std)` passes the scene normalization as arrays
        instead of the `model_norm` callable (then pass None for it):
        applied as `(x - mean) * (1/std)`.

        Returns {'pose' [B, 6] pose6, 'neighbors' [B, K], 'anchor' [B]}
        as tensors on the service's device."""
        self._require_built()
        return self.query_with_db(
            (self.db_desc, self.db_emb, self.db_poses, self.db_valid),
            query_images01, model_norm, rng, norm_ms)

    def query_with_db(self, db: tuple, query_images01, model_norm,
                      rng: int | None = None, norm_ms=None) -> dict:
        """Run the query path against EXPLICIT database tensors
        `db = (desc [M, Dv], emb [M, D], poses [M, 6], valid [M])` instead
        of this service's own (the hook a multi-scene service uses).  Same
        contract as `query` otherwise.  After replicate_over, this rank
        answers its rows of the batch and gathers the others'."""
        with span("service.query"):
            _check_built_hw(self._built_hw, np.shape(query_images01),
                            "query")
            norm = None if norm_ms is not None else model_norm
            rng = 0 if rng is None else int(rng)
            if self._mesh is None or self._db_axis is not None:
                return self._query_fn(norm, db,
                                      self._to_device01(query_images01),
                                      rng, norm_ms)
            rows = batch_rows(self._mesh, len(query_images01))
            out = self._query_fn(norm, db,
                                 self._to_device01(query_images01[rows]),
                                 rng, norm_ms, row0=rows.start)
            return {k: gather_rows(v, self._mesh) for k, v in out.items()}

    def query_stream(self, batches, model_norm, depth: int = 2,
                     rng: int | None = None, norm_ms=None):
        """Pipelined serving: relocalize a stream of query batches.

        Keeps up to `depth` batches enqueued before the oldest result is
        fetched, so batch i+1's host->device upload and launches overlap
        batch i's compute.  Yields one result dict per input batch, in
        order, as numpy arrays.  In stochastic windowed mode each batch
        still reads one boolean back (the window check), which bounds the
        overlap.

        `batches` is any iterable of [B, H, W, 3] arrays (uint8 or float
        in [0, 1]); B may vary."""
        return _pipelined_stream(
            lambda q, r: self.query(q, model_norm, r, norm_ms=norm_ms),
            batches, depth, rng)
