"""Classical VLAD retrieval (the Cambridge path).

Port of `relpose_gnn_tpu/retrieval/vlad.py` (the reference's offline
`external/VLAD/VLADlib`, SURVEY.md section 2.2 E8): ORB local descriptors
-> KMeans visual dictionary -> VLAD aggregation with power and L2
normalisation -> exact top-k over a dense table.

  * `orb_descriptors` and `fit_visual_dictionary` are host calls into
    OpenCV and scikit-learn, imported when called (the card's machine has
    neither; there they raise as the JAX functions do);
  * `vlad_aggregate` runs on the descriptors' device: squared distances
    to the centers by one GEMM, the nearest center by argmin, the
    residual sums by a one-hot assignment GEMM, signed square root, L2;
    batched over images of different descriptor counts by a row mask;
  * `VLADIndex` keeps its [M, K*D] table on its device and returns the
    exact top-k, ties to the lower index (a stable sort), the table
    scored by the port's one scorer (`subsample.similarities`).

The products whose results feed the argmin and the ranking run at full
float32 precision, as the JAX module pins `Precision.HIGHEST`: they
refuse TF32 (`require_full_fp32`).  The index pickle is the JAX module's, `{"centers": [K, D], "descriptors": [M, K*D] or None}` as
float32 numpy arrays, so each package loads the other's index files.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from relpose_gnn_tpu_torch import require_full_fp32, resolve_device
from relpose_gnn_tpu_torch.retrieval.subsample import similarities

BUILD_CHUNK = 256   # images aggregated at a time by `VLADIndex.build`


def orb_descriptors(image_u8: np.ndarray, n_features: int = 500
                    ) -> np.ndarray | None:
    """ORB descriptors of one gray or RGB uint8 image (OpenCV on the
    host): [n, 32] uint8, or None where ORB finds no keypoint."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("OpenCV not available for ORB extraction") from e
    if image_u8.ndim == 3:
        image_u8 = cv2.cvtColor(image_u8, cv2.COLOR_RGB2GRAY)
    orb = cv2.ORB_create(nfeatures=n_features)
    _, desc = orb.detectAndCompute(image_u8, None)
    return desc


def fit_visual_dictionary(descriptors: np.ndarray, k: int,
                          seed: int = 0) -> np.ndarray:
    """KMeans visual dictionary (scikit-learn on the host, 10 restarts):
    [k, D] float32 centers."""
    from sklearn.cluster import KMeans

    km = KMeans(n_clusters=k, n_init=10, random_state=seed)
    km.fit(np.asarray(descriptors, np.float32))
    return km.cluster_centers_.astype(np.float32)


def vlad_aggregate(descriptors: torch.Tensor, centers: torch.Tensor,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """VLAD vector of one image's local descriptors, or of a batch.

    descriptors [P, D] (or [B, P, D]) float, centers [K, D]; `valid`
    [B, P] bool marks the real rows of a padded batch.  Each descriptor
    is hard-assigned to its nearest center (the lower index on a tie),
    the residuals are summed per center, then signed-square-rooted and
    L2-normalised (the reference's `improvedVLAD`).  Returns [K*D] (or
    [B, K*D])."""
    require_full_fp32(descriptors)
    d2 = (torch.sum(descriptors ** 2, dim=-1)[..., None]
          - 2.0 * descriptors @ centers.T
          + torch.sum(centers ** 2, dim=-1))
    assign = torch.nn.functional.one_hot(
        torch.argmin(d2, dim=-1), centers.shape[0]).to(descriptors.dtype)
    if valid is not None:
        assign = assign * valid[..., None].to(assign.dtype)
    agg = assign.transpose(-1, -2) @ descriptors                # [.., K, D]
    mass = torch.sum(assign, dim=-2)[..., None]                 # [.., K, 1]
    v = (agg - mass * centers).flatten(-2)
    v = torch.sign(v) * torch.sqrt(torch.abs(v))                # power norm
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp_min(n, 1e-12)


def _padded(per_image: list, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Ragged [P_i, D] arrays -> ([B, P_max, D] float32, valid [B, P_max])
    on `device`."""
    p_max = max(len(d) for d in per_image)
    dim = np.asarray(per_image[0]).shape[1]
    x = np.zeros((len(per_image), p_max, dim), np.float32)
    valid = np.zeros((len(per_image), p_max), bool)
    for i, d in enumerate(per_image):
        x[i, :len(d)] = d
        valid[i, :len(d)] = True
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(valid).to(device))


class VLADIndex:
    """Dense VLAD descriptor table on a device, with an exact top-k (the
    reference's BallTree replaced).  `centers` [K, D] is the visual
    dictionary; `descriptors` [M, K*D] the table, or None before
    `build`."""

    def __init__(self, centers: np.ndarray,
                 descriptors: np.ndarray | None = None, device=None):
        self.device = resolve_device(device)
        self.centers = np.asarray(centers, np.float32)
        self._centers = torch.from_numpy(self.centers).to(self.device)
        self.table = (None if descriptors is None else torch.from_numpy(
            np.asarray(descriptors, np.float32)).to(self.device))

    @property
    def descriptors(self) -> np.ndarray | None:
        """The table as float32 numpy [M, K*D] (a copy to the host)."""
        return None if self.table is None else self.table.cpu().numpy()

    def describe_batch(self, per_image: list) -> torch.Tensor:
        """VLAD vectors [B, K*D] on the device of a list of per-image
        [P_i, D] local descriptor arrays (each P_i > 0)."""
        x, valid = _padded(per_image, self.device)
        return vlad_aggregate(x, self._centers, valid)

    def describe(self, local_descs: np.ndarray) -> np.ndarray:
        """The VLAD vector [K*D] of one image's local descriptors."""
        x = torch.as_tensor(np.asarray(local_descs, np.float32),
                            device=self.device)
        return vlad_aggregate(x, self._centers).cpu().numpy()

    def build(self, per_image_descs: list) -> None:
        """The table from per-image [P_i, D] local descriptors, BUILD_CHUNK
        images at a time."""
        self.table = torch.cat([
            self.describe_batch(per_image_descs[i:i + BUILD_CHUNK])
            for i in range(0, len(per_image_descs), BUILD_CHUNK)])

    def similarities(self, q: torch.Tensor) -> torch.Tensor:
        """Inner products [B, M] (or [M]) of VLAD vectors q [B, K*D] (or
        [K*D]) with the table, in float32 (`subsample.similarities`)."""
        if self.table is None:
            raise ValueError("the index has no descriptors: build it first")
        q = q.to(self.device, torch.float32)
        sim = similarities(q.reshape(-1, q.shape[-1]), self.table)
        return sim.reshape(q.shape[:-1] + (len(self.table),))

    def query(self, local_descs: np.ndarray, k: int):
        """Top-k most similar database images for one query image: (scores
        [k], indices [k]) as numpy, descending, ties to the lower index."""
        q = torch.as_tensor(np.asarray(local_descs, np.float32),
                            device=self.device)
        sim = self.similarities(vlad_aggregate(q, self._centers))
        scores, idx = torch.sort(sim, descending=True, stable=True)
        return scores[:k].cpu().numpy(), idx[:k].cpu().numpy()

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump({"centers": self.centers,
                         "descriptors": self.descriptors}, f)

    @classmethod
    def load(cls, path: str, device=None) -> "VLADIndex":
        """An index pickle written by either package (only files this
        program or the JAX package wrote: unpickling runs code)."""
        with open(path, "rb") as f:
            d = pickle.load(f)
        return cls(centers=d["centers"], descriptors=d["descriptors"],
                   device=device)
