"""Data: codecs, datasets and the loader (counterpart of phenaki_tpu/data)."""

from phenaki_tpu_torch.data.codecs import (
    crop_center,
    gif_to_tensor,
    tensor_to_video,
    video_tensor_to_gif,
    video_to_tensor,
)
from phenaki_tpu_torch.data.datasets import (
    DataLoader,
    ImageDataset,
    VideoDataset,
    cast_num_frames,
    collate_tensors_and_strings,
)

__all__ = [
    "ImageDataset",
    "VideoDataset",
    "DataLoader",
    "collate_tensors_and_strings",
    "cast_num_frames",
    "video_tensor_to_gif",
    "gif_to_tensor",
    "video_to_tensor",
    "tensor_to_video",
    "crop_center",
]
