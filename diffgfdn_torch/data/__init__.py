"""Host-side data: the three-room and spatial datasets, batch gathering, splits,
synthetic generators."""

from .batching import (
    arrays_from_room_dataset,
    BatchArrays,
    fixed_test_split,
    gather_batch,
    index_batches,
    train_valid_split,
)
from .room_dataset import RoomDataset, ThreeRoomDataset
from .spatial_dataset import (
    arrays_from_spatial_dataset,
    generate_spatial_three_room_pickle,
    SpatialRoomDataset,
    SpatialThreeRoomDataset,
    split_by_grid_resolution,
)
from .synthetic import generate_three_room_pickle, synthetic_three_room_dataset

__all__ = [
    "BatchArrays",
    "RoomDataset",
    "SpatialRoomDataset",
    "SpatialThreeRoomDataset",
    "ThreeRoomDataset",
    "arrays_from_room_dataset",
    "arrays_from_spatial_dataset",
    "fixed_test_split",
    "gather_batch",
    "index_batches",
    "generate_spatial_three_room_pickle",
    "generate_three_room_pickle",
    "split_by_grid_resolution",
    "synthetic_three_room_dataset",
    "train_valid_split",
]
