"""Training data (counterpart of ``vfloodnet_tpu.data``): pseudo-video
clips and augmented stills from annotated images, the detector's
synthetic scenes, and a batch loader. Numpy, with PIL imported inside the
functions that read or warp images."""
from .detection_dataset import (SyntheticPeopleDataset,
                                SyntheticStopsignDataset,
                                render_person_scene, render_stopsign_scene)
from .image_dataset import WaterImageDataset
from .loader import BatchLoader
from .transforms import ClipAugmenter
from .video_dataset import WaterVideoTrainDataset

__all__ = ["BatchLoader", "ClipAugmenter", "SyntheticPeopleDataset",
           "SyntheticStopsignDataset", "WaterImageDataset",
           "WaterVideoTrainDataset", "render_person_scene",
           "render_stopsign_scene"]
