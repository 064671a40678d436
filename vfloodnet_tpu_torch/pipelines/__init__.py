from .loaders import cast_floating_params, load_afb_urr, load_linknet
from .video_seg import VideoSegEngine, run_video_segmentation

__all__ = ["cast_floating_params", "load_afb_urr", "load_linknet",
           "VideoSegEngine", "run_video_segmentation"]
