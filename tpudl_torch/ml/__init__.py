"""The port's ml API: text stages (``lm``), named-image stages
(``named_image``), the Transformer base (``pipeline``) and Params
(``params``)."""

from tpudl_torch.ml.lm import LMClassifier, LMFeaturizer, LMGenerator
from tpudl_torch.ml.named_image import DeepImageFeaturizer, DeepImagePredictor
from tpudl_torch.ml.pipeline import Transformer

__all__ = ["LMFeaturizer", "LMClassifier", "LMGenerator",
           "DeepImageFeaturizer", "DeepImagePredictor", "Transformer"]
