"""Host-side data: the three-room dataset, batch gathering, splits, a synthetic generator."""

from .batching import (
    arrays_from_room_dataset,
    BatchArrays,
    fixed_test_split,
    gather_batch,
    index_batches,
    train_valid_split,
)
from .room_dataset import RoomDataset, ThreeRoomDataset
from .synthetic import generate_three_room_pickle, synthetic_three_room_dataset

__all__ = [
    "BatchArrays",
    "RoomDataset",
    "ThreeRoomDataset",
    "arrays_from_room_dataset",
    "fixed_test_split",
    "gather_batch",
    "index_batches",
    "generate_three_room_pickle",
    "synthetic_three_room_dataset",
    "train_valid_split",
]
