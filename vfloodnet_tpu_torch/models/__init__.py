from .afb_urr import AFBURR, Decoder, EncoderM, EncoderQ, KeyValue
from .resnet import FrozenBN, ResNet50Backbone

__all__ = ["AFBURR", "Decoder", "EncoderM", "EncoderQ", "KeyValue",
           "FrozenBN", "ResNet50Backbone"]
