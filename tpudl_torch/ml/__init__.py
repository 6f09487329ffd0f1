"""The port's ml API: text stages (``lm``), the Transformer base
(``pipeline``) and Params (``params``)."""

from tpudl_torch.ml.lm import LMClassifier, LMFeaturizer, LMGenerator
from tpudl_torch.ml.pipeline import Transformer

__all__ = ["LMFeaturizer", "LMClassifier", "LMGenerator", "Transformer"]
