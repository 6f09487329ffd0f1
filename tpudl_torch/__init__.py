"""tpudl_torch — the PyTorch/CUDA port of tpudl for NVIDIA Hopper.

A package beside ``tpudl`` (the JAX reference, which it never imports):
the same public layouts and stage names, with every Pallas kernel of a
ported path replaced by a kernel written by hand for ``sm_90a``
(``csrc/``, built on first use by :mod:`tpudl_torch._build`). Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.

Ported so far: text serving on ``TinyCausalLM`` — :mod:`tpudl_torch.ml.lm`
(``LMFeaturizer``, ``LMClassifier``, ``LMGenerator``) over
:mod:`tpudl_torch.zoo.transformer`, whose attention runs the
flash-attention forward of :mod:`tpudl_torch.cuda_ops` — and its training
(``TinyCausalLM.loss_fn`` under :mod:`tpudl_torch.train`), whose
gradient runs the flash-attention dq and dk/dv kernels — and the image
path: ``readImages`` (:mod:`tpudl_torch.image`, with the host libjpeg
decoder of :mod:`tpudl_torch.native`) → ``DeepImageFeaturizer`` /
``DeepImagePredictor`` (:mod:`tpudl_torch.ml.named_image`) on InceptionV3
(:mod:`tpudl_torch.zoo`), whose convolutions run on cuDNN.
"""

from tpudl_torch.device import resolve_device
from tpudl_torch.version import __version__

__all__ = ["__version__", "resolve_device"]
