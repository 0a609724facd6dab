"""Room geometry, positional encodings, and CNN patch partitioning.

Port of ``examples/room_geometry_study.py`` (the reference's
``notebooks/visualise_room_geometry.ipynb``), the sanity checks of the
spatial machinery before any training:

1. **Geometry**: the coupled three-room floor plan and a 3-D wireframe of
   the volumes, with receivers and the source overlaid;
2. **One-hot encoding**: every train / valid receiver snaps to a UNIQUE
   nearest mesh point (two receivers in one mesh cell would alias);
3. **Fourier encodings**: the sinusoidal position encoding varies across
   the grid;
4. **CNN square patches**: the square-patch batching partitions the
   receiver grid into non-overlapping patches that jointly cover it.

The encodings run on ``device`` (``models/dnn.py``), the patches on the host
(``data/spatial_dataset.py``). :func:`geometry_checks` returns 2-4,
:func:`geometry_figures` draws 1, :func:`run` does both.

Run: python -m diffgfdn_torch.examples.room_geometry_study [--out /tmp/room_geom] [--device cpu]
"""

import argparse
from pathlib import Path
from typing import Dict, Union

import numpy as np
import torch

from ..data.batching import train_valid_split
from ..data.spatial_dataset import (
    generate_spatial_three_room_pickle,
    SpatialThreeRoomDataset,
    square_patch_indices,
)
from ..models.dnn import one_hot_mesh_encoding, SinusoidalEncoding
from ..utils.device import resolve_device

Device = Union[str, torch.device]


def geometry_figures(room, out: Path):
    """Floor plan + 3-D wireframe with receivers and source overlaid
    (``floor_plan.png``, ``rooms_3d.png``; matplotlib)."""
    from ..utils.plot import draw_room_boundaries, pyplot

    plt = pyplot()
    fig, ax = plt.subplots(figsize=(7, 6))
    draw_room_boundaries(ax, room.room_dims, room.room_start_coord,
                         getattr(room, "aperture_coords", None))
    p = np.asarray(room.receiver_position)
    ax.scatter(p[:, 0], p[:, 1], s=12, label="receivers")
    s = np.asarray(room.source_position).reshape(-1, 3)
    ax.scatter(s[:, 0], s[:, 1], marker="*", s=160, label="source")
    ax.legend()
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    fig.savefig(out / "floor_plan.png", dpi=120)
    plt.close(fig)

    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    for dims, start in zip(room.room_dims, room.room_start_coord):
        x0, y0 = start[0], start[1]
        dx, dy, dz = dims
        for z in (0.0, dz):
            ax.plot([x0, x0 + dx, x0 + dx, x0, x0], [y0, y0, y0 + dy, y0 + dy, y0],
                    [z] * 5, "k-", lw=0.8)
        for cx, cy in ((x0, y0), (x0 + dx, y0), (x0 + dx, y0 + dy), (x0, y0 + dy)):
            ax.plot([cx, cx], [cy, cy], [0.0, dz], "k-", lw=0.8)
    ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=8)
    ax.scatter(s[:, 0], s[:, 1], s[:, 2], marker="*", s=160, c="r")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    fig.savefig(out / "rooms_3d.png", dpi=120)
    plt.close(fig)


def check_one_hot(room, train_idx, valid_idx, pitch_m=0.3, device: Device = "cuda"):
    """Train/valid receivers snap to unique mesh points (no aliasing)."""
    dev = resolve_device(device)
    # floor-plan meshgrid at half the receiver pitch (the RoomDataset
    # meshgrid's role; the spatial dataset carries no mesh of its own)
    p_all = np.asarray(room.receiver_position)
    xs = np.arange(p_all[:, 0].min(), p_all[:, 0].max() + pitch_m, pitch_m)
    ys = np.arange(p_all[:, 1].min(), p_all[:, 1].max() + pitch_m, pitch_m)
    mesh_np = np.stack(np.meshgrid(xs, ys, indexing="ij"), axis=-1).reshape(-1, 2)
    mesh = torch.as_tensor(mesh_np.astype(np.float32), device=dev)
    results = {}
    for name, idx in (("train", train_idx), ("valid", valid_idx)):
        pos_np = np.asarray(room.receiver_position, np.float32)[idx]
        _, closest, rec_idx = one_hot_mesh_encoding(mesh, torch.as_tensor(pos_np, device=dev))
        rec_idx = rec_idx.cpu().numpy()
        # unique nearest cells + snap distance below the mesh pitch
        dist = np.linalg.norm(closest.cpu().numpy() - pos_np[:, :2], axis=-1)
        results[name] = {
            "unique": len(np.unique(rec_idx)) == len(rec_idx),
            "max_snap_m": float(dist.max()),
        }
    return results


def fourier_encoding_variation(room, num_features=10, device: Device = "cuda"):
    """Per-feature std of the sinusoidal encoding across the grid."""
    dev = resolve_device(device)
    pos = torch.as_tensor(np.asarray(room.norm_receiver_position, np.float32), device=dev)
    with torch.no_grad():
        feats = SinusoidalEncoding(num_fourier_features=num_features)(pos)
    return feats.cpu().numpy().std(axis=0)


def check_patches(room, patch_size=2):
    """Square patches partition the grid: disjoint + jointly covering."""
    coords = np.asarray(room.receiver_position)
    spacing = np.diff(np.unique(np.round(coords[:, 0], 3)))
    grid_m = float(np.min(spacing[spacing > 1e-6]))
    patches = square_patch_indices(coords, patch_size, grid_m, step_size=patch_size)
    flat = np.concatenate(patches) if patches else np.empty(0, int)
    return {
        "num_patches": len(patches),
        "disjoint": len(np.unique(flat)) == len(flat),
        "covered": len(np.unique(flat)) / len(coords),
    }


def geometry_checks(out_dir="/tmp/room_geom", seed=0, device: Device = "cuda") -> Dict:
    """Checks 2-4 on a synthetic spatial grid written under ``out_dir``:
    {"one_hot", "feat_std", "patches"} as :func:`run` returns, and the
    ``room``."""
    dev = resolve_device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    pkl = generate_spatial_three_room_pickle(
        out / "srirs.pkl", grid_spacing_m=0.6, rir_len_s=0.1,
        decay_times=(0.05, 0.09, 0.07), seed=seed,
    )
    room = SpatialThreeRoomDataset(pkl)
    train_idx, valid_idx = train_valid_split(np.arange(room.num_rec), 0.8, seed=seed)
    return {
        "one_hot": check_one_hot(room, train_idx, valid_idx, device=dev),
        "feat_std": fourier_encoding_variation(room, device=dev),
        "patches": check_patches(room),
        "room": room,
    }


def run(out_dir="/tmp/room_geom", seed=0, device: Device = "cuda"):
    res = geometry_checks(out_dir, seed, device)
    geometry_figures(res.pop("room"), Path(out_dir))
    feat_std = res["feat_std"]
    print("one-hot encoding:", res["one_hot"])
    print(f"fourier features varying (std > 0.05): "
          f"{int((feat_std > 0.05).sum())}/{len(feat_std)}")
    print("CNN square patches:", res["patches"])
    return res


def main(argv=None):
    parser = argparse.ArgumentParser(description="Room geometry and spatial encodings")
    parser.add_argument("--out", default="/tmp/room_geom")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    return run(args.out, device=args.device)


if __name__ == "__main__":
    main()
