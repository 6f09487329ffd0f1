"""Model zoo of the port: ``transformer`` (TinyCausalLM) and the ten named
image models (``registry``, over ``nn``, ``core`` and the architectures
``inception_v3``, ``xception``, ``resnet``, ``vgg``, ``mobilenet_v2``,
``densenet`` and ``efficientnet``)."""

from tpudl_torch.zoo.convert import (load_params_npz, save_params_npz,
                                     torch_params)
from tpudl_torch.zoo.preprocessing import decode_predictions, preprocess_input
from tpudl_torch.zoo.registry import (SUPPORTED_MODELS, ImageModel,
                                      NamedModel, getKerasApplicationModel)
from tpudl_torch.zoo.transformer import TinyCausalLM, load_jax_params

__all__ = ["TinyCausalLM", "load_jax_params", "SUPPORTED_MODELS",
           "NamedModel", "ImageModel", "getKerasApplicationModel",
           "preprocess_input", "decode_predictions", "torch_params",
           "save_params_npz", "load_params_npz"]
