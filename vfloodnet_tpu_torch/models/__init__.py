from .afb_urr import AFBURR, Decoder, EncoderM, EncoderQ, KeyValue
from .efficientnet import EfficientNetFeatures
from .hrnet import HRNet
from .linknet import LinkNet
from .metro import (BodyMeshRegressor, METRONetwork,
                    load_default_mesh_regressor)
from .resnet import FrozenBN, ResNet50Backbone

__all__ = ["AFBURR", "Decoder", "EncoderM", "EncoderQ", "KeyValue",
           "EfficientNetFeatures", "LinkNet", "FrozenBN", "ResNet50Backbone",
           "HRNet", "BodyMeshRegressor", "METRONetwork",
           "load_default_mesh_regressor"]
