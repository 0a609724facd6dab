"""Neural-acoustic-field (NAF) comparison containers and the barycentric
interpolation baseline (port of ``data/naf.py``; host numpy and scipy).

The tolerant unpickler reads the NAF pickles of either package, and of the
reference framework (whose classes lived in ``dataclass``), as this
package's classes, and maps the reference's dataset modules to this
package's; it refuses every other class of the JAX package.
"""

from dataclasses import dataclass, field
import pickle
from typing import Any, Dict, Optional

import numpy as np


@dataclass
class NAFDatasetTrain:
    """Training-split container for NAF comparisons."""

    receiver_position: np.ndarray
    rirs: np.ndarray
    sample_rate: float
    metadata: Dict[str, Any] = field(default_factory=dict)


@dataclass
class NAFDatasetInfer:
    """Inference-split container (positions only; RIRs predicted)."""

    receiver_position: np.ndarray
    predicted_rirs: Optional[np.ndarray] = None
    sample_rate: float = 48000.0
    metadata: Dict[str, Any] = field(default_factory=dict)


@dataclass
class BarycentricInterpolatedDataset:
    """RIRs barycentrically interpolated from measured neighbours."""

    receiver_position: np.ndarray
    rirs: np.ndarray
    weights: np.ndarray              # (num_query, 3) barycentric weights
    simplex_indices: np.ndarray      # (num_query, 3) source-measurement ids
    sample_rate: float = 48000.0


_CLASSES = {c.__name__: c for c in (NAFDatasetTrain, NAFDatasetInfer,
                                    BarycentricInterpolatedDataset)}


class TolerantUnpickler(pickle.Unpickler):
    """Maps the NAF containers of ``dataclass`` (the reference framework),
    ``diffgfdn_tpu.data.naf`` and this module to this module's classes, and
    the reference's ``spatial_sampling`` / ``diff_gfdn`` dataset classes to
    this package's datasets; refuses any other ``diffgfdn_tpu`` class."""

    def find_class(self, module: str, name: str):
        if name in _CLASSES and module in ("dataclass", "diffgfdn_tpu.data.naf", __name__):
            return _CLASSES[name]
        if module.startswith("spatial_sampling"):
            from . import spatial_dataset

            if hasattr(spatial_dataset, name):
                return getattr(spatial_dataset, name)
        if module.startswith("diff_gfdn"):
            from . import room_dataset

            if hasattr(room_dataset, name):
                return getattr(room_dataset, name)
        if module.split(".")[0] == "diffgfdn_tpu":
            raise pickle.UnpicklingError(f"refusing {module}.{name}: not a NAF container")
        return super().find_class(module, name)


def load_pickle_tolerant(path):
    """Load a NAF pickle of either package (or of the reference framework)."""
    with open(path, "rb") as f:
        return TolerantUnpickler(f).load()


def barycentric_interpolate(
    measured_positions: np.ndarray,
    measured_rirs: np.ndarray,
    query_positions: np.ndarray,
) -> BarycentricInterpolatedDataset:
    """Barycentric RIR interpolation over a 2-D Delaunay triangulation of the
    measured (x, y) positions; a query outside the hull takes its nearest
    measurement."""
    from scipy.spatial import Delaunay

    pts = np.asarray(measured_positions)[:, :2]
    tri = Delaunay(pts)
    q = np.asarray(query_positions)[:, :2]
    simplex = tri.find_simplex(q)
    out_rirs = np.zeros((len(q), measured_rirs.shape[-1]), measured_rirs.dtype)
    weights = np.zeros((len(q), 3))
    indices = np.zeros((len(q), 3), np.int64)
    for i, s in enumerate(simplex):
        if s < 0:  # outside the hull: nearest neighbour
            j = int(np.argmin(np.linalg.norm(pts - q[i], axis=-1)))
            out_rirs[i] = measured_rirs[j]
            weights[i, 0] = 1.0
            indices[i] = j
            continue
        verts = tri.simplices[s]
        t = tri.transform[s]
        bary = t[:2] @ (q[i] - t[2])
        w = np.append(bary, 1.0 - bary.sum())
        out_rirs[i] = np.einsum("k,kt->t", w, measured_rirs[verts])
        weights[i] = w
        indices[i] = verts
    return BarycentricInterpolatedDataset(
        receiver_position=np.asarray(query_positions),
        rirs=out_rirs,
        weights=weights,
        simplex_indices=indices,
    )
