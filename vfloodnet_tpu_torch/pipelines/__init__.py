from .loaders import cast_floating_params, load_afb_urr, load_linknet
from .object_detection import est_by_obj_detection
from .reference_tracking import est_by_reference
from .streaming_waterlevel import (BoundedResolver, StreamingWaterLevel,
                                   run_streaming_waterlevel)
from .video_seg import VideoSegEngine, run_video_segmentation
from .video_seg_batch import BatchVideoSegEngine, run_video_segmentation_batch

__all__ = ["cast_floating_params", "load_afb_urr", "load_linknet",
           "BatchVideoSegEngine", "BoundedResolver", "StreamingWaterLevel",
           "VideoSegEngine", "est_by_obj_detection", "est_by_reference",
           "run_streaming_waterlevel", "run_video_segmentation",
           "run_video_segmentation_batch"]
