from .afb_urr import AFBURR, Decoder, EncoderM, EncoderQ, KeyValue
from .efficientnet import EfficientNetFeatures
from .hrnet import HRNet
from .linknet import LinkNet
from .linknet_smp import LinkNetSMP
from .metro import (BodyMeshRegressor, METRONetwork,
                    load_default_mesh_regressor)
from .pspnet import PSPNet
from .resnet import FrozenBN, ResNet50Backbone, TrainBN

__all__ = ["AFBURR", "Decoder", "EncoderM", "EncoderQ", "KeyValue",
           "EfficientNetFeatures", "LinkNet", "LinkNetSMP", "FrozenBN",
           "TrainBN", "ResNet50Backbone",
           "HRNet", "BodyMeshRegressor", "METRONetwork", "PSPNet",
           "load_default_mesh_regressor"]
