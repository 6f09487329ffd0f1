"""The port's ml API: text stages (``lm``), named-image stages
(``named_image``), ``TFImageTransformer`` (``tf_image``), the Keras
surface (``keras_tensor``, ``tf_tensor``, ``keras_image``, ``estimator``),
model selection (``tuning``, over ``hpo``'s trial scheduler),
``LogisticRegression`` (``classification``), the pipeline bases
(``pipeline``) and Params (``params``)."""

from tpudl_torch.ml.classification import (LogisticRegression,
                                           LogisticRegressionModel)
from tpudl_torch.ml.estimator import KerasImageFileEstimator
from tpudl_torch.ml.keras_image import KerasImageFileTransformer
from tpudl_torch.ml.keras_tensor import KerasTransformer
from tpudl_torch.ml.lm import LMClassifier, LMFeaturizer, LMGenerator
from tpudl_torch.ml.named_image import DeepImageFeaturizer, DeepImagePredictor
from tpudl_torch.ml.pipeline import (Estimator, Model, Pipeline, PipelineModel,
                                     Transformer)
from tpudl_torch.ml.tf_image import TFImageTransformer
from tpudl_torch.ml.tf_tensor import TFTransformer
from tpudl_torch.ml.tuning import (CrossValidator, CrossValidatorModel,
                                   FunctionEvaluator, ParamGridBuilder)

__all__ = ["LMFeaturizer", "LMClassifier", "LMGenerator",
           "DeepImageFeaturizer", "DeepImagePredictor", "TFImageTransformer",
           "KerasTransformer", "TFTransformer", "KerasImageFileTransformer",
           "KerasImageFileEstimator", "LogisticRegression",
           "LogisticRegressionModel", "ParamGridBuilder", "CrossValidator",
           "CrossValidatorModel", "FunctionEvaluator", "Transformer",
           "Estimator", "Model", "Pipeline", "PipelineModel"]
