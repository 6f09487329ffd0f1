"""The port's ml API: text stages (``lm``), named-image stages
(``named_image``), the Keras surface (``keras_tensor``, ``tf_tensor``,
``keras_image``, ``estimator``), ``LogisticRegression``
(``classification``), the pipeline bases (``pipeline``) and Params
(``params``)."""

from tpudl_torch.ml.classification import (LogisticRegression,
                                           LogisticRegressionModel)
from tpudl_torch.ml.estimator import KerasImageFileEstimator
from tpudl_torch.ml.keras_image import KerasImageFileTransformer
from tpudl_torch.ml.keras_tensor import KerasTransformer
from tpudl_torch.ml.lm import LMClassifier, LMFeaturizer, LMGenerator
from tpudl_torch.ml.named_image import DeepImageFeaturizer, DeepImagePredictor
from tpudl_torch.ml.pipeline import (Estimator, Model, Pipeline, PipelineModel,
                                     Transformer)
from tpudl_torch.ml.tf_tensor import TFTransformer

__all__ = ["LMFeaturizer", "LMClassifier", "LMGenerator",
           "DeepImageFeaturizer", "DeepImagePredictor", "KerasTransformer",
           "TFTransformer", "KerasImageFileTransformer",
           "KerasImageFileEstimator", "LogisticRegression",
           "LogisticRegressionModel", "Transformer", "Estimator", "Model",
           "Pipeline", "PipelineModel"]
