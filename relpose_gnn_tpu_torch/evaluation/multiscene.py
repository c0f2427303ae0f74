"""Multi-scene relocalization: one model, every scene (PyTorch).

Port of `relpose_gnn_tpu/evaluation/multiscene.py`.  The reference's
headline configuration is a single model trained on all 7 scenes and
evaluated per scene.  Here every per-scene quantity is data handed to the
one query path of a shared `RelocalizationService`:

  * the database tensors (descriptors, embeddings, poses, validity) go in
    through `RelocalizationService.query_with_db`; every scene's tables
    have `ServiceConfig.capacity` rows behind a validity mask, the same
    mechanism that powers incremental growth;
  * the scene's pixel normalization goes in as the `norm_ms=(mean, std)`
    tensors, applied as `(x - mean) * (1/std)` at query time and when the
    scene's frames are embedded, so a scene's tables are bit-identical to
    those of a single-scene service that queries with the same `norm_ms`.

What differs from the JAX service, and why: nothing is compiled, so there
is no `query_compiles`; a scene's tables are allocated once at `capacity`
rows and written in place; weights live in the modules.  The snapshot has
the JAX service's keys (`"<scene>/desc"`, `"<scene>/norm_mean"`, ...), and
the model fingerprint is the port's (see evaluation/service.py).

Scene databases support the whole mutation surface of the single-scene
service (`add_frames`, `invalidate_frames`, `compact_scene`) through the
same helpers, plus `save_database` / `load_database` with the per-scene
normalization stats inside the snapshot.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from relpose_gnn_tpu_torch.evaluation.service import (
    _RANK_DTYPES, RelocalizationService, ServiceConfig, _check_built_hw,
    _check_fingerprint, _compact, _model_fingerprint, _pipelined_stream,
    _pose_rows, _tombstone)


@dataclasses.dataclass
class SceneDatabase:
    """One scene's state on the device.  `norm_ms` holds the scene's pixel
    normalization (mean, std), applied inside the query path."""
    desc: torch.Tensor    # [capacity, Dv]
    emb: torch.Tensor     # [capacity, D]
    poses: torch.Tensor   # [capacity, 6]
    valid: torch.Tensor   # [capacity] bool
    count: int            # rows in use
    norm_ms: tuple        # (mean [3], std [3]) float32 on the device
    hw: tuple | None = None  # (H, W) the scene was embedded at: queries
    #                          and add_frames must match it (backbone
    #                          embeddings depend on the resolution)

    def as_tuple(self):
        return self.desc, self.emb, self.poses, self.valid


class MultiSceneService:
    """One model and one query path serving many scenes.

    Wraps a single `RelocalizationService` (which owns the model
    preparation: BN folding, compact edges, the device) and a dict of
    `SceneDatabase`s.  Every query runs the same path on the target
    scene's tensors and normalization."""

    def __init__(self, model, netvlad, cfg: ServiceConfig,
                 **service_kwargs):
        if cfg.capacity is None:
            raise ValueError(
                "MultiSceneService requires ServiceConfig.capacity: every "
                "scene's tables share one shape — set capacity >= the "
                "largest scene's frame count")
        self._svc = RelocalizationService(model, netvlad, cfg,
                                          **service_kwargs)
        self.cfg = cfg
        self.device = self._svc.device
        self._scenes: dict[str, SceneDatabase] = {}

    # -- embedding (shared across scenes) ------------------------------

    @staticmethod
    def _norm_fn(norm_ms):
        """A scene's (mean, std) as the normalization callable the shared
        service embeds with, in the query path's reciprocal-multiply
        form, so a scene's tables are what its queries are compared with.
        `1.0 / std` is a division of tensors: dividing by a Python scalar
        multiplies by its reciprocal on CUDA."""
        mean, std = norm_ms

        def norm(x01):
            return (x01 - mean) * (1.0 / std)

        return norm

    # -- scene management ----------------------------------------------

    def add_scene(self, name: str, db_images01: np.ndarray,
                  db_poses: np.ndarray, mean, std, batch: int = 16) -> None:
        """Embed a scene's database split and register it under `name`.
        `mean`/`std` are the scene's pixel-normalization stats (the
        7-Scenes per-scene stats.txt values, Cambridge 0.5/0.25); they
        ride with the scene.  Images: float in [0, 1] or uint8, same
        contract as `RelocalizationService.build`."""
        if name in self._scenes:
            raise ValueError(f"scene {name!r} already added")
        cap = int(self.cfg.capacity)
        m = len(db_images01)
        if m > cap:
            raise ValueError(f"scene {name!r} has {m} frames > capacity "
                             f"{cap}")
        if m == 0:
            raise ValueError(f"scene {name!r} has no frames")
        pose_rows = _pose_rows(db_poses, m, f"add_scene({name!r})",
                               self.device)
        norm_ms = tuple(
            torch.as_tensor(np.asarray(a, np.float32).reshape(3),
                            device=self.device) for a in (mean, std))
        desc, emb = self._svc._write_rows(
            db_images01, self._norm_fn(norm_ms), batch, 0, None, None, cap)
        poses = torch.zeros((cap, 6), dtype=torch.float32,
                            device=self.device)
        poses[:m] = pose_rows
        self._scenes[name] = SceneDatabase(
            desc=desc, emb=emb, poses=poses,
            valid=torch.arange(cap, device=self.device) < m, count=m,
            norm_ms=norm_ms, hw=tuple(np.shape(db_images01)[1:3]))

    def _db(self, scene: str) -> SceneDatabase:
        try:
            return self._scenes[scene]
        except KeyError:
            raise KeyError(
                f"unknown scene {scene!r}: this service has "
                f"{sorted(self._scenes) if self._scenes else 'no scenes'}"
            ) from None

    def scenes(self) -> list[str]:
        return list(self._scenes)

    def scene_count(self, name: str) -> int:
        return self._db(name).count

    # -- serving ---------------------------------------------------------

    def query(self, scene: str, query_images01,
              rng: int | None = None) -> dict:
        """Relocalize a batch of raw [B, H, W, 3] images against `scene`'s
        database, with `scene`'s normalization, through the path every
        other scene shares.  Same return contract as
        `RelocalizationService.query`."""
        db = self._db(scene)
        _check_built_hw(db.hw, np.shape(query_images01),
                        f"query({scene!r})")
        return self._svc.query_with_db(db.as_tuple(), query_images01, None,
                                       rng, norm_ms=db.norm_ms)

    def query_stream(self, scene: str, batches, depth: int = 2,
                     rng: int | None = None):
        """Pipelined serving of one scene's query stream (the schedule
        shared with `RelocalizationService.query_stream`)."""
        self._db(scene)  # fail on an unknown scene before any launch
        return _pipelined_stream(
            lambda q, r: self.query(scene, q, r), batches, depth, rng)

    # -- per-scene mutations (the single-scene service's semantics) ------

    def add_frames(self, scene: str, images01, poses,
                   batch: int = 16) -> None:
        """Grow one scene's database in place, into its free capacity
        slots.  The scene's registered normalization is used; there is no
        model_norm argument to mismatch."""
        db = self._db(scene)
        _check_built_hw(db.hw, np.shape(images01), f"add_frames({scene!r})")
        n_new = len(images01)
        cap = int(self.cfg.capacity)
        if db.count + n_new > cap:
            raise ValueError(
                f"capacity exceeded for scene {scene!r}: "
                f"{db.count} + {n_new} > {cap}")
        pose_rows = _pose_rows(poses, n_new, f"add_frames({scene!r})",
                               self.device)
        self._svc._write_rows(images01, self._norm_fn(db.norm_ms), batch,
                              db.count, db.desc, db.emb, cap)
        db.poses[db.count:db.count + n_new] = pose_rows
        db.valid[db.count:db.count + n_new] = True
        db.count += n_new

    def invalidate_frames(self, scene: str, indices) -> None:
        """Tombstone frames of one scene (never retrieved again)."""
        db = self._db(scene)
        _tombstone(db.valid, db.count, indices)

    def compact_scene(self, scene: str) -> np.ndarray:
        """Reclaim one scene's tombstoned slots (stable front compaction;
        returns the old_to_new slot map, see
        `RelocalizationService.compact_database`)."""
        db = self._db(scene)
        (db.desc, db.emb, db.poses, db.valid, db.count,
         old_to_new) = _compact(db.desc, db.emb, db.poses, db.valid,
                                db.count)
        return old_to_new

    # -- persistence -------------------------------------------------------

    def save_database(self, path: str) -> None:
        """Persist every scene's database to one npz (arrays prefixed by
        scene; bfloat16 widened to float32 exactly, like
        `RelocalizationService.save_database`)."""
        def host(x):
            return (x.float() if x.dtype == torch.bfloat16 else x
                    ).cpu().numpy()

        def name_of(dt):
            return str(dt).removeprefix("torch.")

        struct, checksum = _model_fingerprint(self._svc.model)
        payload = {"scenes": np.asarray(sorted(self._scenes)),
                   "retrieval_hw": np.asarray(self.cfg.retrieval_hw,
                                              np.int64),
                   "retrieval": np.asarray(self.cfg.retrieval),
                   "model_struct": np.asarray(struct),
                   "model_checksum": np.float64(checksum)}
        for name, db in self._scenes.items():
            payload[f"{name}/desc"] = host(db.desc)
            payload[f"{name}/emb"] = host(db.emb)
            payload[f"{name}/poses"] = host(db.poses)
            payload[f"{name}/valid"] = host(db.valid)
            payload[f"{name}/count"] = np.int64(db.count)
            payload[f"{name}/desc_dtype"] = name_of(db.desc.dtype)
            payload[f"{name}/emb_dtype"] = name_of(db.emb.dtype)
            payload[f"{name}/norm_mean"] = host(db.norm_ms[0])
            payload[f"{name}/norm_std"] = host(db.norm_ms[1])
            payload[f"{name}/hw"] = np.asarray(db.hw or (0, 0), np.int64)
        np.savez(path, **payload)

    def load_database(self, path: str) -> None:
        """Restore a save_database() snapshot (all scenes).  Capacity and
        retrieval mode/resolution must match the saving config: the same
        fail-loudly contracts as the single-scene loader.

        Replaces the service's scene registry wholesale (like the
        single-scene loader replaces its tables): scenes added before the
        load are dropped, never mixed with restored ones."""
        z = np.load(path)
        if "scenes" not in z.files:
            raise ValueError(
                f"{path} is not a MultiSceneService snapshot (no 'scenes' "
                "key — a single-scene RelocalizationService.save_database "
                "file? load it through RelocalizationService instead)")
        snap_mode = (str(z["retrieval"]) if "retrieval" in z.files
                     else "netvlad")
        if snap_mode != self.cfg.retrieval:
            raise ValueError(
                f"snapshot was built with retrieval={snap_mode!r} but this "
                f"service is configured for {self.cfg.retrieval!r}; "
                "descriptors from different retrieval modes are not "
                "comparable")
        snap_hw = tuple(int(v) for v in z["retrieval_hw"])
        if snap_mode == "netvlad" and snap_hw != tuple(self.cfg.retrieval_hw):
            raise ValueError(
                f"snapshot was built with retrieval_hw={snap_hw} but this "
                f"service embeds queries at {tuple(self.cfg.retrieval_hw)};"
                " mixed-resolution descriptors are not comparable")
        _check_fingerprint(z, self._svc.model, path)
        cap = int(self.cfg.capacity)
        dev = self.device
        restored: dict[str, SceneDatabase] = {}
        for name in (str(s) for s in z["scenes"]):
            m = z[f"{name}/desc"].shape[0]
            if m != cap:
                raise ValueError(
                    f"scene {name!r} snapshot rows ({m}) != capacity "
                    f"({cap}); saved under a different ServiceConfig")
            emb_dt = _RANK_DTYPES.get(str(z[f"{name}/emb_dtype"]))
            if emb_dt is None:
                raise ValueError(
                    f"scene {name!r} snapshot emb_dtype "
                    f"{z[f'{name}/emb_dtype']!r} is neither float32 nor "
                    "bfloat16")
            restored[name] = SceneDatabase(
                # cast to THIS service's rank_dtype (same contract as the
                # single-scene loader; see ServiceConfig.rank_dtype)
                desc=torch.as_tensor(z[f"{name}/desc"], device=dev).to(
                    self._svc._rank_dt),
                emb=torch.as_tensor(z[f"{name}/emb"], device=dev).to(emb_dt),
                poses=torch.as_tensor(z[f"{name}/poses"], device=dev),
                valid=torch.as_tensor(z[f"{name}/valid"], device=dev),
                count=int(z[f"{name}/count"]),
                norm_ms=(torch.as_tensor(z[f"{name}/norm_mean"], device=dev),
                         torch.as_tensor(z[f"{name}/norm_std"], device=dev)),
                hw=(tuple(int(v) for v in z[f"{name}/hw"])
                    if f"{name}/hw" in z.files
                    and int(z[f"{name}/hw"][0]) > 0 else None))
        # atomic swap: a validation error in the middle of a load leaves
        # the registry untouched rather than half-restored
        self._scenes = restored
