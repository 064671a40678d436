from .loaders import cast_floating_params, load_afb_urr, load_linknet
from .reference_tracking import est_by_reference
from .streaming_waterlevel import (BoundedResolver, StreamingWaterLevel,
                                   run_streaming_waterlevel)
from .video_seg import VideoSegEngine, run_video_segmentation

__all__ = ["cast_floating_params", "load_afb_urr", "load_linknet",
           "BoundedResolver", "StreamingWaterLevel", "VideoSegEngine",
           "est_by_reference", "run_streaming_waterlevel",
           "run_video_segmentation"]
