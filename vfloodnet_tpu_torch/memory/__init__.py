from .feature_bank import FeatureBank, FeatureBankState

__all__ = ["FeatureBank", "FeatureBankState"]
