from .loaders import cast_floating_params, load_afb_urr, load_linknet
from .object_detection import est_by_obj_detection
from .reference_tracking import est_by_reference
from .streaming_waterlevel import (BoundedResolver, StreamingWaterLevel,
                                   run_streaming_waterlevel)
from .video_seg import VideoSegEngine, run_video_segmentation
from .video_seg_batch import BatchVideoSegEngine, run_video_segmentation_batch
from .video_seg_sharded import (ShardedVideoSegEngine,
                                run_video_segmentation_sharded)

__all__ = ["cast_floating_params", "load_afb_urr", "load_linknet",
           "BatchVideoSegEngine", "BoundedResolver", "ShardedVideoSegEngine",
           "StreamingWaterLevel",
           "VideoSegEngine", "est_by_obj_detection", "est_by_reference",
           "run_streaming_waterlevel", "run_video_segmentation",
           "run_video_segmentation_batch", "run_video_segmentation_sharded"]
