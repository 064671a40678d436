from .checkpoint import load_bank_checkpoint, save_bank_checkpoint
from .feature_bank import FeatureBank, FeatureBankState

__all__ = ["FeatureBank", "FeatureBankState", "load_bank_checkpoint",
           "save_bank_checkpoint"]
