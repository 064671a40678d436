from .attention import bank_attention_read
from .bank_update import bank_merge_append
from .cc import connected_components, largest_connected_component
from .pad import pad_divide_by, unpad
from .pooling import local_avg_pool, local_max_pool
from .resize import resize, short_side_size
from .uncertainty import calc_uncertainty
from .waterline import waterline_below, waterline_below_batch, waterline_scan

__all__ = [
    "bank_attention_read", "bank_merge_append", "connected_components",
    "largest_connected_component", "pad_divide_by", "unpad",
    "local_avg_pool", "local_max_pool", "resize", "short_side_size",
    "calc_uncertainty", "waterline_below", "waterline_below_batch",
    "waterline_scan",
]
