"""Training data (counterpart of ``vfloodnet_tpu.data``): pseudo-video
clips from annotated stills, and a batch loader. Numpy, with PIL imported
inside the functions that read or warp images."""
from .loader import BatchLoader
from .transforms import ClipAugmenter
from .video_dataset import WaterVideoTrainDataset

__all__ = ["BatchLoader", "ClipAugmenter", "WaterVideoTrainDataset"]
