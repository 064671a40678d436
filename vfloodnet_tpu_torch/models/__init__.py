from .afb_urr import AFBURR, Decoder, EncoderM, EncoderQ, KeyValue
from .efficientnet import EfficientNetFeatures
from .linknet import LinkNet
from .resnet import FrozenBN, ResNet50Backbone

__all__ = ["AFBURR", "Decoder", "EncoderM", "EncoderQ", "KeyValue",
           "EfficientNetFeatures", "LinkNet", "FrozenBN", "ResNet50Backbone"]
