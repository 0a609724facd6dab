"""Host-side data: single RIRs, the three-room and spatial datasets, batch
gathering, splits, synthetic generators."""

from .batching import (
    arrays_from_room_dataset,
    BatchArrays,
    fixed_test_split,
    gather_batch,
    index_batches,
    train_valid_split,
)
from .audio import read_wav, write_wav
from .room_dataset import early_late_split, RIRData, RoomDataset, ThreeRoomDataset
from .spatial_dataset import (
    arrays_from_spatial_dataset,
    create_2d_grid_data,
    generate_spatial_three_room_pickle,
    SpatialRoomDataset,
    SpatialThreeRoomDataset,
    split_by_grid_resolution,
    square_patch_indices,
)
from .synthetic import generate_three_room_pickle, synthetic_three_room_dataset

__all__ = [
    "BatchArrays",
    "RIRData",
    "RoomDataset",
    "SpatialRoomDataset",
    "SpatialThreeRoomDataset",
    "ThreeRoomDataset",
    "arrays_from_room_dataset",
    "arrays_from_spatial_dataset",
    "create_2d_grid_data",
    "early_late_split",
    "fixed_test_split",
    "gather_batch",
    "index_batches",
    "read_wav",
    "generate_spatial_three_room_pickle",
    "generate_three_room_pickle",
    "split_by_grid_resolution",
    "square_patch_indices",
    "synthetic_three_room_dataset",
    "train_valid_split",
    "write_wav",
]
