"""Host-side data: the three-room dataset, batch gathering, a synthetic generator."""

from .batching import arrays_from_room_dataset, BatchArrays, gather_batch
from .room_dataset import RoomDataset, ThreeRoomDataset
from .synthetic import generate_three_room_pickle, synthetic_three_room_dataset

__all__ = [
    "BatchArrays",
    "RoomDataset",
    "ThreeRoomDataset",
    "arrays_from_room_dataset",
    "gather_batch",
    "generate_three_room_pickle",
    "synthetic_three_room_dataset",
]
