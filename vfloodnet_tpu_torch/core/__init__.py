from .checkpoint import load_flat_npz
from .convert import (convert_afb_urr_variables, convert_linknet_variables,
                      convert_metro_variables, convert_pspnet_variables,
                      convert_rcnn_variables)
from .device import resolve_device

__all__ = ["load_flat_npz", "convert_afb_urr_variables",
           "convert_linknet_variables", "convert_rcnn_variables",
           "convert_metro_variables", "convert_pspnet_variables",
           "resolve_device"]
