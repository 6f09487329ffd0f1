"""tpudl_torch — the PyTorch/CUDA port of tpudl for NVIDIA Hopper.

A package beside ``tpudl`` (the JAX reference, which it never imports):
the same public layouts and stage names, with every Pallas kernel of a
ported path replaced by a kernel written by hand for ``sm_90a``
(``csrc/``, built on first use by :mod:`tpudl_torch._build`). Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.

Ported so far, slice by slice:

- text serving on ``TinyCausalLM`` (:mod:`tpudl_torch.ml.lm`:
  ``LMFeaturizer``, ``LMClassifier``, ``LMGenerator``), whose attention
  runs the flash-attention forward of :mod:`tpudl_torch.cuda_ops`, and its
  training (:mod:`tpudl_torch.train`), whose gradient runs the dq and
  dk/dv kernels;
- the image path: ``readImages`` (:mod:`tpudl_torch.image`, with the host
  libjpeg decoder of :mod:`tpudl_torch.native`) → ``DeepImageFeaturizer``
  / ``DeepImagePredictor`` on the ten named models of
  :mod:`tpudl_torch.zoo` (cuDNN convolutions);
- the pipelined executor, ``Frame.map_batches`` (:mod:`tpudl_torch.frame`);
- ``HorovodRunner`` training over ``torch.distributed`` with checkpoints
  and gang restarts (:mod:`tpudl_torch.train`, :mod:`tpudl_torch.mesh`);
- the Keras surface: ``.keras`` files read and written without keras
  (:mod:`tpudl_torch.ingest`), ``TFInputGraph``, ``KerasTransformer``,
  ``TFTransformer``, ``KerasImageFileTransformer``,
  ``KerasImageFileEstimator``, ``LogisticRegression`` and ``Pipeline``;
- model selection and models as SQL UDFs: ``TFImageTransformer``,
  ``fitMultiple`` over :mod:`tpudl_torch.ml.hpo`'s trial scheduler,
  ``ParamGridBuilder``/``CrossValidator`` (:mod:`tpudl_torch.ml.tuning`),
  :func:`tpudl_torch.frame.sql`, and :mod:`tpudl_torch.udf`
  (``register_udf``, ``makeGraphUDF``, ``registerKerasImageUDF``,
  ``register_text_udfs``);
- the data layer (:mod:`tpudl_torch.data`): wire codecs, the shard cache,
  the device-memory batch cache and ``Dataset``, under the executor, the
  stages, the estimator and ``lm_dataset`` (:mod:`tpudl_torch.text`);
- jobs, faults and the supervisor: ``JobSpec``/``JobRuntime``
  (:mod:`tpudl_torch.jobs`; SIGTERM → checkpoint → exit 75 → resume), the
  fault-injection harness (:mod:`tpudl_torch.testing.faults`), the
  executor's and the server's degradation ladder
  (:mod:`tpudl_torch.frame.supervisor`) and the flight recorder
  (:mod:`tpudl_torch.obs.flight`);
- the analyzers (:mod:`tpudl_torch.analysis`, ``python -m
  tpudl_torch.analysis``), the lock sanitizer
  (:mod:`tpudl_torch.testing.tsan`, ``TPUDL_TSAN=1``), the capture-storm
  sentinel (:mod:`tpudl_torch.testing.traceck`, ``TPUDL_TRACECK=1``) and
  the numerical-debug hooks (:mod:`tpudl_torch.debug`).

The names below load lazily, as tpudl's top-level names do (its
``_LAZY`` map, restricted to what the port has).
"""

import importlib
import os as _os

from tpudl_torch.device import resolve_device
from tpudl_torch.version import __version__

if _os.environ.get("TPUDL_TRACECK", "0") == "1":
    # recompile-storm sentinel (tpudl_torch.testing.traceck): install the
    # counting capture shim BEFORE any module captures a graph, as tpudl
    # installs its jit shim
    from tpudl_torch.testing import traceck as _traceck  # noqa: F401

# symbol → defining module: the subset of tpudl's _LAZY that is ported
_LAZY = {
    "Frame": "tpudl_torch.frame",
    "sql": "tpudl_torch.frame",
    "register_udf": "tpudl_torch.udf",
    "DeepImageFeaturizer": "tpudl_torch.ml",
    "DeepImagePredictor": "tpudl_torch.ml",
    "TFImageTransformer": "tpudl_torch.ml",
    "TFTransformer": "tpudl_torch.ml",
    "KerasTransformer": "tpudl_torch.ml",
    "KerasImageFileTransformer": "tpudl_torch.ml",
    "Pipeline": "tpudl_torch.ml",
    "PipelineModel": "tpudl_torch.ml",
    "TFInputGraph": "tpudl_torch.ingest",
    "GraphFunction": "tpudl_torch.ingest",
    "IsolatedSession": "tpudl_torch.ingest",
    "KerasImageFileEstimator": "tpudl_torch.ml.estimator",
    "ParamGridBuilder": "tpudl_torch.ml.tuning",
    "CrossValidator": "tpudl_torch.ml.tuning",
    "LogisticRegression": "tpudl_torch.ml",
    "registerKerasImageUDF": "tpudl_torch.udf.keras_image_model",
    "RetryPolicy": "tpudl_torch.jobs",
    "JobSpec": "tpudl_torch.jobs",
    "JobRuntime": "tpudl_torch.jobs",
    "ByteTokenizer": "tpudl_torch.text",
    "WordTokenizer": "tpudl_torch.text",
    "TokenCodec": "tpudl_torch.text",
    "lm_dataset": "tpudl_torch.text",
    "Dataset": "tpudl_torch.data",
    "U8Codec": "tpudl_torch.data",
    "BF16Codec": "tpudl_torch.data",
    "ShardCache": "tpudl_torch.data",
    "LMFeaturizer": "tpudl_torch.ml",
    "LMGenerator": "tpudl_torch.ml",
    "LMClassifier": "tpudl_torch.ml",
    "flash_attention": "tpudl_torch.cuda_ops",
    "TinyCausalLM": "tpudl_torch.zoo.transformer",
}

__all__ = ["__version__", "resolve_device", *_LAZY]


def __getattr__(name):
    # lazy re-exports keep `import tpudl_torch` light (no model zoo, no
    # executor) until a symbol is used
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'tpudl_torch' has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
