from .backbone import DetectionResNet
from .fpn import FPN
from .heads import BoxHead, CoarseMaskHead, KeypointHead, MaskHead, PointHead
from .meta import (GeneralizedRCNN, RCNNConfig, build_detector,
                   keypoint_rcnn_config, load_default_detector,
                   stopsign_rcnn_config)
from .rpn import RPN, decode_boxes, generate_anchors

__all__ = ["DetectionResNet", "FPN", "RPN", "generate_anchors",
           "decode_boxes", "BoxHead", "MaskHead", "CoarseMaskHead",
           "PointHead", "KeypointHead", "GeneralizedRCNN", "RCNNConfig",
           "build_detector", "keypoint_rcnn_config", "load_default_detector",
           "stopsign_rcnn_config"]
