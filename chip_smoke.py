#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``tpudl_torch``) on one NVIDIA
GPU. Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

1. Print the card's name and power limit; refuse to run without CUDA.
   TF32 is switched off for matmuls and cuDNN, so f32 runs in full f32.
2. Build every kernel of the port from ``tpudl_torch/csrc`` with nvcc.
3. Hold each kernel against its plain PyTorch version on the card, in f32
   and bf16, over the CPU tests' cases and the slices' shapes: the
   forward, then the dq and dk/dv backward kernels under a nonzero lse
   cotangent; each also on scores large enough that one TF32 pass would
   miss the f32 tolerance, on rows that are not 16-byte aligned, and twice
   at its path's shape to show that a launch repeats bit for bit.
4. Drive the serving slice at full width — ``TinyCausalLM(vocab=32000,
   dim=1024, heads=16, layers=12)`` from seeded random weights — through
   ``LMFeaturizer``, ``LMClassifier`` and ``LMGenerator``; check that
   every decoder block of every featurize/classify batch launched the
   flash kernel, hold two rows of each stage against the same stages run
   on the CPU, and profile one featurize batch (kernel time by name).
4b. Drive the training slice at full width — ``TinyCausalLM(vocab=50257,
   dim=512, heads=8, layers=12)`` (README's training recipe) from seeded
   random weights — through ``Trainer(lm.loss_fn(), adamw(3e-4)).fit`` on
   8 dense-packed rows of 1025 tokens a step; check that every step
   launched each of the three kernels once per decoder block and that
   the loss fell, hold a small batch's loss, gradients and 3-step losses
   against the same run on the CPU, and profile one step.
5. Time each kernel at its slice's shape against its plain version, one
   PyTorch library call and the card's bound (for f32 the tensor cores'
   3xTF32 rate, with the f32 FFMA figure beside it), and the forward also
   at the training shape.
6. Drive the image slice at full width — ``DeepImageFeaturizer(modelName=
   "InceptionV3", weights="random")`` at 299×299 — over 512 seeded uint8
   BGR image structs in batches of 64, plus 256 at 480×640 (the
   antialiased resize), in f32 and bf16, and ``DeepImagePredictor`` on 64
   rows; where PIL imports, also over ``readImages`` of 64 JPEGs. cuDNN's
   TF32 setting is back at PyTorch's default (allowed) for this phase, so
   the f32 checks hold the stages' own precision. Print images/s (median
   and spread of 5 windows each), achieved TFLOP/s against the bounds,
   and the per-batch function's rate alone; hold 4 rows (and 2 of the
   480×640 batch) against the same stage on the CPU, bf16 against f32,
   and a profile split of one batch in each dtype. Then the other nine
   named models, each at its own input size from seeded random weights:
   ResNet50 and Xception (BASELINE.json configs[1]) with the featurizer
   and the predictor over 512 rows in f32 and bf16, and VGG16, VGG19,
   MobileNetV2, DenseNet121, ResNet101, ResNet152 and EfficientNetB0 with
   the featurizer over 256 rows in f32 and bf16 and one predictor call;
   each prints its parameter count, counted work, rates (median and
   spread of 5 windows) and the time of its leg, holds bf16 against f32,
   and holds 2 rows (features, and scores for configs[1]) against the CPU
   run with perturbed BN stats. Last, after every timed run, a profile
   split of one ResNet50 and one Xception batch in each dtype, and the
   check that no attention kernel launched in the phase. Then print the
   ``{"kernels": [...]}`` line of phase 5.

7. Drive the pipelined executor (``Frame.map_batches``: prepare pool, K-deep
   infeed, D-deep dispatch window, fused dispatch as a CUDA-graph replay)
   under the image and LM stages, each in three arms: serial
   (``TPUDL_FRAME_PREFETCH=0``), pipelined (the defaults K=2, N=2, D=2)
   and fused (``fuseSteps=4``). Image arms: InceptionV3 f32 and bf16,
   ResNet50 f32 and bf16 and MobileNetV2 bf16, each over 512 rows in
   batches of 64: images/s (median and spread of 5 windows), the
   ``PipelineReport`` stages and gauges, the per-batch function's own
   rate, and, last, the card's idle share from one profile over a whole
   8-batch transform of each arm. Pipelined and fused outputs must equal
   the serial arm's bitwise (or, where the graph's kernels differ from
   eager's, within phase 6's 2e-5 of max |y|, with the reason printed).
   LM arms: ``LMFeaturizer`` at serving width (256 rows, batch 16):
   rows/s, features bitwise equal to the serial arm's, and 12 flash
   forward launches a batch in every arm, graph replays included. Then
   ``readImages`` of 512 seeded JPEGs with ``numPartition=8`` into the
   f32 InceptionV3 featurizer, serial against pipelined (decode in the
   prepare pool), and one f32 fused run with the caller's TF32 on, held
   to the CPU within 2e-5 of max |y|.

8. Drive ResNet50 training (BASELINE.json configs[3], ``bench.py``'s
   ``measure_train_step``) through ``HorovodRunner(np=1).run(train_fn)``
   on a one-rank NCCL group, ``init(0)`` f32 masters, batches of 64 uint8
   images at 224×224 normalized on the card, ``sgd(0.05)``: steps/s and
   images/s (median and spread of 5 windows of 10 steps) in f32 and under
   ``with_compute_dtype(loss_fn, torch.bfloat16)``, with the training
   convolutions on NCHW memory (the port's) and on channels_last (as
   before it), beside the earlier channels_last rates, the achieved
   TFLOP/s and the f32 FFMA
   and bf16 bounds, and the gradient all-reduce's calls and bytes a step;
   2 f32 steps at batch 4 from perturbed BN statistics held against the
   same run on the CPU, and the first step's gradients against a float64
   run on the card (on NCHW memory within 1e-2 of the largest, as phase 9
   holds InceptionV3's; on channels_last printed), and the same for the
   named InceptionV3 at 299×299; the
   fixed-batch eval loss (``make_eval_step``) of ``bench.py``'s band set
   (bf16 compute) falling over 60 steps; a run that fails at step 7 and
   restarts from its step-5 checkpoint (adam) equal, bit for bit under
   ``cudnn.deterministic``, to an uninterrupted run, with the save and
   restore seconds; a profile split of one f32 and one bf16-compute step
   with the card's idle share; no flash kernel launch in the phase.

9. Drive the Keras surface at full width from ``.keras`` files the port
   writes itself (``save_keras_file``; the card's machine has no keras),
   from seeded weights: configs[4] (``bench.py``'s
   ``measure_keras_transformer``), ``KerasTransformer`` over 65,536 rows ×
   100 at ``batchSize=8192`` (rows/s, median and spread of 5 windows; 64
   rows against the CPU); configs[2] (``measure_estimator_inception``),
   ``KerasImageFileEstimator`` fine-tuning Keras InceptionV3 + a Dense(2)
   softmax head (the committed ``config.json`` fixture) on 96 seeded
   299×299 JPEGs, batch 16, 1 epoch, adam, categorical cross-entropy:
   time-to-fit cold and warm, steps/s, the step losses, the train loop
   alone, the trained file read back bit for bit, 2 steps at batch 4
   against the CPU (losses, and updates in the 2-norm), the returned
   transformer on 16 images against the CPU, and a 3-epoch fit whose last
   epoch's loss is below its first; the same fit over Keras Xception + a
   Dense(2) head (time-to-fit, steps/s, the file read back; card vs CPU
   and the first step's gradients against float64 on perturbed BN); the
   Keras MobileNetV2 and EfficientNetB0 bases at 224×224 through
   ``KerasImageFileTransformer`` over 256 JPEGs, batch 64 (images/s; 2
   rows with perturbed BN against the CPU); ``DeepImageFeaturizer`` on
   Xception and MobileNetV2 with ``weights=`` the base's Keras file,
   held against ``KerasImageFileTransformer`` on that file and the same
   images; the committed legacy ``tests/fixtures/keras/cnn.h5`` through
   ``KerasImageFileTransformer`` against the CPU; then
   ``DeepImageFeaturizer("InceptionV3")`` features of 256 rows into
   ``LogisticRegression(maxIter=100)`` on the card and the CPU (falling
   loss, probabilities held); no flash launch; last, a profile split of
   one estimator step.

10. Drive model selection and models as SQL UDFs at full width, from the
   ``.keras`` files of phase 9 written anew: ``CrossValidator`` over
   configs[2]'s ``KerasImageFileEstimator`` (2 learning rates × 2 folds
   of the 96 JPEGs; each trial's seconds and final loss, the completion
   order, ``avgMetrics``, ``bestIndex``, the fit's wall time cold and
   warm), its trials' losses against a plain loop of ``fit`` calls bit
   for bit under ``cudnn.deterministic``, and ``fitMultiple`` with a trial
   that fails once under a ``trialRetryPolicy`` (1 retry, the same losses
   as without the failure); ``TFImageTransformer`` over the same file on
   256 structs at 299×299 (images/s beside the named InceptionV3
   featurizer's, 16 rows against the CPU, BGR against RGB on flipped
   input bit for bit, ``outputMode="image"``); ``registerKerasImageUDF``
   through ``sql`` with WHERE and LIMIT 64 (exactly 64 rows featurized,
   equal bit for bit to ``TFImageTransformer``) and a GROUP BY/AVG over
   its output; configs[4]'s MLP as ``makeGraphUDF`` through ``sql``
   (rows/s beside ``KerasTransformer``'s, equal bit for bit); and
   ``register_text_udfs`` at phase 4's serving width: ``embed`` and
   ``classify`` over phase 4's 256 texts (12 flash forward launches a
   batch, none backward) and ``generate`` over its prompts, each equal
   bit for bit to its LM stage, with rows/s.

11. Drive TF graph ingestion at full width: every committed TF fixture
   (``tests/fixtures/tf``: the float64 factory graph as a frozen
   ``.pb``, a TF1 SavedModel and a Saver checkpoint; a TF2 export; two
   Keras ``model.export`` files) through every ``TFInputGraph`` route, on the
   card against the CPU port (2e-5 of max |y|; the float64 graph 1e-12
   and against 3x + 4); configs[2]'s InceptionV3 + head as a SavedModel
   (the committed ``saved_model.pb``, its ``variables/`` written here by
   ``tf_bundle_writer`` from phase 9's seeded, BN-perturbed weights):
   the time to ingest (the bundle read with its CRC-32C check, the
   route), ``fromSavedModelWithSignature`` against ``fromKeras`` on the
   same weights and against the CPU (2e-5 of max |y|, 4 rows at
   299×299), ``TFImageTransformer`` over it and over the ``.keras`` graph
   in turn (images/s, 256 structs, batch 64, f32, 5 windows), its
   ``fuseSteps=4`` arm bit for bit, ``makeGraphUDF`` over it through
   ``sql`` (WHERE, LIMIT 64) bit for bit against ``TFImageTransformer``;
   ``TFTransformer`` over the float64 checkpoint graph by signature
   names, a ``GraphFunction.fromList`` UDF; no flash launch.

The last line is ``{"ok": true, "device": {"platform": "gpu", ...}}``.

``python3 chip_smoke.py --image-only`` runs phase 1 and then phase 6
alone, every model's leg: the image slice's rates in a process that has
run no profiler session before them (phases 4 and 4b profile a batch and
a step). ``python3 chip_smoke.py --executor-only`` runs phase 1 and then
phase 7 alone. ``python3 chip_smoke.py --train-only`` runs phase 1 and then phase 8
alone. ``python3 chip_smoke.py --keras-only`` runs phase 1 and then phase 9
alone. ``python3 chip_smoke.py --surface-only`` runs phase 1 and then
phase 10 alone. ``python3 chip_smoke.py --graph-only`` runs phase 1 and then phase 11
alone. ``python3 chip_smoke.py --ranks N`` (N cards) runs phase 1 and
then ``HorovodRunner(np=N)``: N spawned ranks, one card each, NCCL, held
against one rank on the same global batch, and its rate against one
rank's. ``python3 chip_smoke.py --pool-study`` runs phase 1 and
then the prepare pool's study alone: the host-bound bf16 image cells in
five executor arms that separate the pool's threads from the window
(serial; D=2 with no pool; N=1; N=2, the default; N=2 with one torch
CPU thread), images/s over 11 windows and the report's host seconds a
batch of each arm.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

T_START = time.perf_counter()     # the script's own time, printed at the end
SEED = 0
VOCAB, DIM, HEADS, LAYERS, MAX_LEN = 32000, 1024, 16, 12, 4096
N_ROWS, BATCH = 256, 16            # featurize / classify: 16 batches each
TEXT_BYTES = (600, 1023)           # + BOS, every batch pads to 1024 tokens
PROMPTS = ["The port runs on the card", "Flash attention",
           "Serving a causal language model answers", "tpudl"]
MAX_NEW = 16
CLASSES = ["positive", "negative", "mixed"]
SLICE_SHAPE = (16, 1024, 16, 64)   # [B, S, H, D] of every decoder block

# training slice: README's TinyCausalLM training recipe, 8 rows of 1025
# dense-packed tokens a step (1024 predicted positions each)
TRAIN_ARCH = dict(vocab=50257, dim=512, heads=8, layers=12)
TRAIN_BATCH, TRAIN_SEQ = 8, 1025
TRAIN_SHAPE = (8, 1024, 8, 64)     # [B, S, H, D] of every decoder block
WARMUP_STEPS, TIMED_STEPS = 2, 20
LR = 3e-4
CPU_TOKENS, CPU_STEPS = 257, 3     # the card-vs-CPU batch: 1 row

# H100 SXM data-sheet peaks (dense): memory rate and the rate for the
# inputs' type. An f32-accurate product on the tensor cores takes three TF32
# passes (3xTF32, as the backward kernels and PyTorch's memory-efficient
# attention run f32), so for f32 the least time for the operations is the
# lesser of FFMAs at 67 TFLOP/s and 3 passes at the 495 TFLOP/s TF32 rate
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
TF32_OPS_PER_S = 495e12
TF32_PASSES = 3

# kernel vs plain on the card. f32: both compute in f32 with the products
# and sums in another order (D <= 128 terms, up to 1024 keys).
# bf16: both widen to f32 and round the output to bf16 once, so they may
# differ by one bf16 ulp (2^-7 relative); lse stays f32 in both.
TOL = {"float32": {"o_abs": 2e-5, "o_rel": 0.0, "lse_abs": 2e-5},
       "bfloat16": {"o_abs": 1e-3, "o_rel": 2.0 ** -7, "lse_abs": 2e-5}}
# backward kernels vs the plain backward: the same reasoning, with the
# gradients' own scale (they sum up to 1024 products and reach ~10 here):
# f32 within 2e-5 of max(1, max |grad|); bf16 also one bf16 ulp of each
# value, since each side rounds its f32 result to bf16 once
GRAD_TOL = {"float32": {"abs": 2e-5, "rel": 0.0},
            "bfloat16": {"abs": 2e-5, "rel": 2.0 ** -7}}
# GPU vs CPU run of the whole f32 model: 12 layers of 1024/4096-wide
# products summed in other orders, on a host CPU whose own summation order
# varies by machine. Pooled features (up to ~3.1) differed by 2.1e-6 and
# by 1.7e-5 on two H100 machines (PERF.md): the limit leaves about 6x the
# larger reading. Class scores (up to ~0.39) differed by 2.3e-6 where the
# features differed by 2.1e-6, and are held to the same limit.
FEATURE_ATOL = 1e-4
SCORE_ATOL = 1e-4
# GPU vs CPU training of the full-width model on one row of 257 tokens,
# 12 f32 layers summed in other orders (first reading on an H100, PERF.md):
# the first loss (~10.8, one f32 ulp 9.5e-7) differed by 1.9e-6, so 2e-5;
# block 0's wq/wk/wv gradients, held relative to their largest value
# (3.2e-2), by 8.1e-7 of it with scalar-FMA backward kernels and 1.4e-6
# with the tensor-core ones, so 2e-5 (the serving features' error moved 8x
# between machines with the CPU's summation order); the losses of 3
# AdamW steps by 1.9e-6, so 5e-5 (Adam's √v̂ can amplify a gradient's
# rounding)
TRAIN_LOSS_ATOL = 2e-5
TRAIN_GRAD_RTOL = 2e-5
TRAIN_STEPS_ATOL = 5e-5

# image slice: README's first example, sparkdl's flagship
IMAGE_MODEL = "InceptionV3"
IMAGE_ROWS, IMAGE_BATCH = 512, 64  # 8 batches at the model's 299×299
IMAGE_BIG = (480, 640)             # through the antialiased resize
IMAGE_BIG_ROWS = 256               # 4 batches at 480×640
IMAGE_WINDOWS = 5                  # timed windows of each rate (median, spread)
IMAGE_CPU_ROWS = 4                 # card vs CPU rows (and 2 of the big batch)
# card vs CPU run of the f32 stage, relative to max |y| (init(0) features
# are ~5e-3, so an absolute bound would prove nothing): 94 conv layers
# summed in other orders, on cuDNN's algorithms (FFT among them) and the
# host's. First reading on an H100 (PERF.md): features 1.3e-6 (299x299)
# and 1.0e-6 (480x640) of max |y|, scores 2.3e-7; the limit leaves ~16x
# the largest, as the CPU's own summation order varies by machine.
IMAGE_CPU_RTOL = 2e-5
# bf16 against f32 on the card, relative to max |y|: read 1.13e-2 on an
# H100; on the CPU the port's bf16 read 1.2e-2 of its f32 and tpudl's
# 1.4e-2 of its f32.
IMAGE_BF16_RTOL = 3e-2
# softmax rows of the predictor sum to 1 within: f32, a few ulps of 1000
# terms; bf16, each score rounded to bf16 once (2^-9 relative), so 2^-8
SOFTMAX_SUM_ATOL = {"float32": 1e-4, "bfloat16": 2.0 ** -8}

# the rest of the zoo, each at its own input size, after InceptionV3's leg.
# configs[1] of BASELINE.json, "DeepImagePredictor ResNet50/Xception
# ImageNet-1k batch inference": featurizer and predictor rates over
# IMAGE_ROWS rows in f32 and bf16, and a profile split of each dtype
CONFIG1_MODELS = ("ResNet50", "Xception")
# the other seven: featurizer rates over ZOO_ROWS rows in f32 and bf16 and
# one predictor call, no profile
ZOO_MODELS = ("VGG16", "VGG19", "MobileNetV2", "DenseNet121", "ResNet101",
              "ResNet152", "EfficientNetB0")
ZOO_ROWS = 256
# card vs CPU rows of every leg, with perturbed BN stats (the limit is
# IMAGE_CPU_RTOL, as for InceptionV3)
ZOO_CPU_ROWS = 2

# phase 7, the executor: each (model, dtype) over IMAGE_ROWS rows in
# batches of IMAGE_BATCH (8 batches), the LM featurizer over N_ROWS rows
# in batches of BATCH (16 batches), in three arms each
EXEC_IMAGE = (("InceptionV3", "float32"), ("InceptionV3", "bfloat16"),
              ("ResNet50", "float32"), ("ResNet50", "bfloat16"),
              ("MobileNetV2", "bfloat16"))
EXEC_FUSE = 4
EXEC_ARMS = {"serial": {}, "pipelined": {}, "fused": {"fuseSteps": EXEC_FUSE}}
# the pool study (--pool-study): host-bound bf16 cells, arms in turn
POOL_MODELS = ("ResNet50", "InceptionV3", "MobileNetV2")
POOL_WINDOWS = 11
POOL_ARMS = {
    "serial": dict(prefetch=False, dispatch_depth=1),
    "window, no pool": dict(prefetch=False, dispatch_depth=2),
    "pool N=1": dict(prefetch_depth=2, prepare_workers=1, dispatch_depth=2),
    "pool N=2": dict(prefetch_depth=2, prepare_workers=2, dispatch_depth=2),
    "pool N=2, 1 torch thread": dict(prefetch_depth=2, prepare_workers=2,
                                     dispatch_depth=2),
}
EXEC_JPEGS = 512                   # readImages leg, numPartition=8
EXEC_PARTITIONS = 8
# phase 8, ResNet50 training through HorovodRunner (BASELINE.json
# configs[3], bench.py's measure_train_step): batches of 64 uint8 images
# at 224×224, 4 pre-built batches cycled, sgd(0.05)
RESNET_BATCH, RESNET_SIDE, RESNET_LR = 64, 224, 0.05
RESNET_WINDOWS, RESNET_WINDOW_STEPS = 5, 10
RESNET_FLOPS = 3 * 7.71e9          # forward + backward per 224×224 image
RESNET_CPU_BATCH, RESNET_CPU_STEPS = 4, 2  # card vs CPU, perturbed BN
# card vs CPU, f32: cuDNN's and the CPU's convolutions sum in other
# orders, and an activation within rounding of 0 can fall on the other
# side of a ReLU. Read 4.8e-7 (loss) and 6.2e-4 (updates) on the H100;
# the loss keeps phase 4b's 2e-5, the updates get 8x their reading
RESNET_CPU_LOSS_ATOL = 2e-5
RESNET_CPU_UPDATE_RTOL = 5e-3      # of the largest |p_after - p_before|
# the first f32 step's gradients (batch 4, perturbed BN) against a float64
# run on the card, relative to the largest gradient: phase 9's limit for
# InceptionV3 (there NHWC memory read 8.4e-2, NCHW 1.9e-3)
RESNET_GRAD_RTOL = 1e-2
# the rates this phase read when training ran on channels_last memory
# (NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's
RESNET_CHANNELS_LAST_RATES = {"float32": "652.4-659.7",
                              "bfloat16": "689.4-855.5"}
CURVE_CLASSES, CURVE_BATCH, CURVE_POOL = 8, 32, 8   # bench.py's band set
CURVE_STEPS, CURVE_EVERY = 60, 10
CKPT_STEPS, CKPT_EVERY, CKPT_FAIL_AT = 10, 5, 7


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return res.stdout.strip() or f"nvidia-smi rc {res.returncode}"


def cuda_ms(fn, reps: int = 20) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def visible_pairs(s_q, s_k, causal, q_offset, k_offset) -> int:
    """(query, key) pairs the causal mask leaves visible — the work the
    kernel cannot skip on these inputs."""
    if not causal:
        return s_q * s_k
    return sum(min(s_k, max(0, q_offset + i - k_offset + 1))
               for i in range(s_q))


def bound(nbytes, ops, dtype_name):
    """(ms, what bounds it, the FFMA figure): the larger of the bytes over
    the memory rate and the operations over the peak rate for the inputs'
    type. For f32 that rate is the better of the FFMA peak and 3xTF32 on
    the tensor cores; the FFMA figure is the bound with the FFMA peak
    alone (None for bf16)."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    ffma = None
    if dtype_name == "float32":
        ffma = max(t_bytes, t_ops)
        t_ops = min(t_ops, TF32_PASSES * ops / TF32_OPS_PER_S * 1e3)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), ffma


def flash_bound(shape, s_k, dtype_name, causal=True, q_offset=0,
                k_offset=0):
    """The forward reads q, k, v once and writes O and lse; it does 4·D
    flops per visible pair (QKᵀ and PV)."""
    b, s_q, h, d = shape
    item = 4 if dtype_name == "float32" else 2
    nbytes = item * b * h * d * (2 * s_q + 2 * s_k) + 4 * b * s_q * h
    ops = 4 * b * h * d * visible_pairs(s_q, s_k, causal, q_offset, k_offset)
    return (*bound(nbytes, ops, dtype_name), nbytes, ops)


def bwd_bounds(shape, dtype_name):
    """Causal self-attention backward at ``shape`` (Sq = Sk): dq reads q,
    k, v, dO, lse and dlt once and writes dq, 6·D flops per visible pair
    (QKᵀ, dO·Vᵀ, ds·K); dk/dv reads the same and writes dk and dv, 8·D
    flops per pair (QKᵀ, dO·Vᵀ, dsᵀ·Q, pᵀ·dO). Returns ``{kernel: (ms,
    by, FFMA ms, bytes, flops)}``."""
    b, s, h, d = shape
    item = 4 if dtype_name == "float32" else 2
    pairs = b * h * visible_pairs(s, s, True, 0, 0)
    rows = b * s * h
    out = {}
    for name, tensors, flops in (("dq", 5, 6), ("dkv", 6, 8)):
        nbytes = item * rows * d * tensors + 4 * 2 * rows
        ops = flops * d * pairs
        out[name] = (*bound(nbytes, ops, dtype_name), nbytes, ops)
    return out


def check_ptxas(logs):
    """Print nvcc's ``-Xptxas=-v`` lines (``{source: log}``) that name each
    kernel instance and give its registers and spills; fail if an f32
    D=64 instance (the one both paths run) spills."""
    import re

    want = {"flash_attn_fwd": {"fwd"}, "flash_attn_bwd": {"bwd_dq", "bwd_dkv"}}
    entry, seen = "", set()
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line
            elif not ("registers" in line or "spill" in line):
                continue
            print(f"  {name}: {line.strip()}")
            m = re.search(r"flash_(fwd|bwd_dq|bwd_dkv)_kernelIfLi64E", entry)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
            if m and spill:
                seen.add(m.group(1))
                if spill.group(1, 2) != ("0", "0"):
                    fail(f"the f32 D=64 {m.group(1)} kernel spills: "
                         f"{line.strip()}")
    missing = set().union(*(want[n] for n in logs if n in want)) - seen
    if missing:
        fail(f"no spill report for the f32 D=64 kernels {sorted(missing)}")


def bound_text(b, ms) -> str:
    """One line on a kernel's bound ``b`` (from flash_bound / bwd_bounds)
    and the rate its time ``ms`` achieves."""
    bound_ms, by, ffma, nbytes, ops = b
    text = f"bound {bound_ms:.4f} ms by {by}"
    if ffma is not None:
        text += f" at 3xTF32 (FFMA bound {ffma:.4f} ms)"
    return (f"{text} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP); "
            f"achieved {ops / ms / 1e9:.1f} TFLOP/s")


def bound_keys(b, ms) -> dict:
    """The bound's keys of an f32 ``kernels`` entry: ``bound_ms`` and
    ``bound_by`` (bytes or operations, the latter at the 3xTF32 rate), the
    FFMA figure and the achieved rate."""
    bound_ms, by, ffma, _, ops = b
    return {"bound_ms": bound_ms, "bound_by": by, "bound_ffma_ms": ffma,
            "tflops": ops / ms / 1e9}


def check_flash():
    """Phase 3: kernel vs plain on the card; returns the f32 max abs O
    error at the serving shape.

    As for the backward (``check_flash_bwd``): "large scores" draws q and
    k ×3, where one TF32 pass would miss the f32 tolerance; "unaligned
    rows" passes views one element into a D+1-wide buffer, which the
    wrapper copies before the kernel's cp.async loads; the serving case
    runs twice and its O and lse must be bitwise equal."""
    from tpudl_torch import cuda_ops

    gen = torch.Generator().manual_seed(SEED)

    def rand(*shape, dtype, mul=1.0):
        return (torch.randn(*shape, generator=gen) * mul).to("cuda", dtype)

    # (name, q shape, Sk, causal, q_offset, k_offset)
    cases = [("dense", (2, 64, 2, 32), 64, False, 0, 0),
             ("causal", (2, 64, 2, 32), 64, True, 0, 0),
             ("shifted q_offset", (2, 32, 2, 32), 32, True, 32, 0),
             ("fully-future K", (2, 16, 2, 32), 16, True, 0, 1000),
             ("Sq != Sk", (2, 48, 2, 32), 80, True, 0, 0),
             ("S=200", (1, 200, 2, 64), 200, True, 0, 0),
             ("D=16", (2, 130, 3, 16), 130, True, 0, 0),
             ("D=128", (2, 130, 3, 128), 77, False, 0, 0),
             ("large scores", (2, 130, 3, 64), 130, True, 0, 0),
             ("unaligned rows", (2, 70, 2, 32), 70, True, 0, 0),
             ("serving", SLICE_SHAPE, SLICE_SHAPE[1], True, 0, 0)]
    slice_err = None
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).split(".")[1]]
        for name, (b, s_q, h, d), s_k, causal, q_off, k_off in cases:
            mul = 3.0 if name == "large scores" else 1.0
            pad = 1 if name == "unaligned rows" else 0
            q = rand(b, s_q, h, d + pad, dtype=dtype, mul=mul)[..., pad:]
            k = rand(b, s_k, h, d + pad, dtype=dtype, mul=mul)[..., pad:]
            v = rand(b, s_k, h, d + pad, dtype=dtype)[..., pad:]
            kw = dict(causal=causal, q_offset=q_off, k_offset=k_off,
                      return_lse=True)
            o, lse = cuda_ops.flash_attention(q, k, v, **kw)
            po, plse = cuda_ops.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            diff = (o.float() - po.float()).abs()
            o_abs = diff.max().item()
            o_rel = (diff / po.float().abs().clamp_min(1e-6)).max().item()
            lse_abs = (lse - plse).abs().max().item()
            ok = (bool((diff <= tol["o_abs"]
                        + tol["o_rel"] * po.float().abs()).all())
                  and lse_abs <= tol["lse_abs"])
            if name == "fully-future K":
                ok = ok and bool((o == 0).all()) and bool((lse < -1e29).all())
            print(f"  flash {str(dtype)[6:]:8s} {name:16s} q{(b, s_q, h, d)}"
                  f" Sk={s_k}: O max abs {o_abs:.3e} rel {o_rel:.3e}, "
                  f"lse max abs {lse_abs:.3e} {'ok' if ok else 'MISS'}")
            if not ok:
                fail(f"flash kernel disagrees with its plain version "
                     f"({dtype}, {name}; tolerance {tol})")
            if name != "serving":
                continue
            o2, lse2 = cuda_ops.flash_attention(q, k, v, **kw)
            same = torch.equal(o2, o) and torch.equal(lse2, lse)
            print(f"  flash {str(dtype)[6:]:8s} {name:16s} second launch: "
                  f"O, lse {'bitwise equal' if same else 'DIFFER'}")
            if not same:
                fail(f"the forward kernel did not repeat bit for bit "
                     f"({dtype}, {name})")
            if dtype == torch.float32:
                slice_err = o_abs
        # ring contract: two half-K calls merge through their lse weights
        q, k, v = (rand(2, 64, 2, 32, dtype=dtype) for _ in range(3))
        o1, l1 = cuda_ops.flash_attention(q, k[:, :32], v[:, :32],
                                          return_lse=True)
        o2, l2 = cuda_ops.flash_attention(q, k[:, 32:], v[:, 32:],
                                          return_lse=True)
        m = torch.maximum(l1, l2)
        w1, w2 = torch.exp(l1 - m)[..., None], torch.exp(l2 - m)[..., None]
        merged = (o1.float() * w1 + o2.float() * w2) / (w1 + w2)
        want = cuda_ops.flash_attention_plain(q, k, v).float()
        err = (merged - want).abs().max().item()
        # each half's O was rounded to the working type before the merge
        lim = 2e-5 if dtype == torch.float32 else 2 ** -7 * 4
        print(f"  flash {str(dtype)[6:]:8s} lse merge of two K halves: "
              f"max abs {err:.3e} {'ok' if err <= lim else 'MISS'}")
        if err > lim:
            fail(f"lse merge off by {err} ({dtype})")
    return slice_err


def check_flash_bwd():
    """Phase 3, backward: the dq and dk/dv kernels (through
    ``flash_attention_bwd``) vs the plain backward on the card, on the
    forward kernel's outputs under random dO and dlse cotangents; returns
    the f32 max abs errors at the training shape, ``{"dq", "dkv"}``.

    "large scores" draws q and k ×3, so the scores have a standard
    deviation near 9: one TF32 pass (about 2⁻¹¹·|s| of error in s) would
    move p by tenths of a percent and miss the f32 tolerance, so the case
    shows that the 3-pass split holds f32 accuracy. The training case runs
    twice and its gradients must be bitwise equal: every output tile has
    one owning block and no atomics. "unaligned rows" passes views that
    start one element into a D+1-wide buffer, so no row is 16-byte aligned
    and the wrapper copies them before the kernels' cp.async loads."""
    from tpudl_torch import cuda_ops

    gen = torch.Generator().manual_seed(SEED + 2)

    def rand(*shape, dtype=torch.float32, mul=1.0):
        return (torch.randn(*shape, generator=gen) * mul).to("cuda", dtype)

    # (name, q shape, Sk, causal, q_offset, k_offset)
    cases = [("dense", (2, 64, 2, 32), 64, False, 0, 0),
             ("causal", (2, 64, 2, 32), 64, True, 0, 0),
             ("shifted q_offset", (2, 32, 2, 32), 32, True, 32, 0),
             ("fully-future K", (2, 16, 2, 32), 16, True, 0, 1000),
             ("Sq != Sk", (2, 48, 2, 32), 80, True, 0, 0),
             ("Sq != Sk, shifted", (2, 80, 2, 32), 48, True, 0, 40),
             ("S=200", (1, 200, 2, 64), 200, True, 0, 0),
             ("D=16", (2, 130, 3, 16), 130, True, 0, 0),
             ("D=128", (2, 130, 3, 128), 77, False, 0, 0),
             ("strided dO", (2, 96, 3, 64), 96, True, 0, 0),
             ("training", TRAIN_SHAPE, TRAIN_SHAPE[1], True, 0, 0),
             ("large scores", (2, 130, 3, 64), 130, True, 0, 0),
             ("unaligned rows", (2, 70, 2, 32), 70, True, 0, 0)]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = GRAD_TOL[str(dtype).split(".")[1]]
        for name, (b, s_q, h, d), s_k, causal, q_off, k_off in cases:
            mul = 3.0 if name == "large scores" else 1.0
            pad = 1 if name == "unaligned rows" else 0
            q = rand(b, s_q, h, d + pad, dtype=dtype, mul=mul)[..., pad:]
            k = rand(b, s_k, h, d + pad, dtype=dtype, mul=mul)[..., pad:]
            v = rand(b, s_k, h, d + pad, dtype=dtype)[..., pad:]
            kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
            o, lse = cuda_ops.flash_attention(q, k, v, return_lse=True, **kw)
            if name == "strided dO":   # a [B, H, S, D] buffer seen as [B, S, H, D]
                do = rand(b, h, s_q, d, dtype=dtype).transpose(1, 2)
            else:
                do = rand(b, s_q, h, d + pad, dtype=dtype)[..., pad:]
            dlse = rand(b, s_q, h)
            got = cuda_ops.flash_attention_bwd(q, k, v, o, lse, do, dlse, **kw)
            want = cuda_ops.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                      dlse, **kw)
            torch.cuda.synchronize()
            ok, report, case_err = True, [], {}
            for gname, g, w in zip(("dq", "dk", "dv"), got, want):
                g, w = g.float(), w.float()
                diff = (g - w).abs()
                scale = max(1.0, w.abs().max().item())
                ok = ok and bool((diff <= tol["abs"] * scale
                                  + tol["rel"] * w.abs()).all())
                if name == "fully-future K":
                    ok = ok and bool((g == 0).all())
                case_err[gname] = diff.max().item()
                report.append(f"{gname} {case_err[gname]:.3e}/{scale:.2e}")
            print(f"  flash bwd {str(dtype)[6:]:8s} {name:17s} "
                  f"q{(b, s_q, h, d)} Sk={s_k}: max abs err/scale "
                  f"{', '.join(report)} {'ok' if ok else 'MISS'}")
            if not ok:
                fail(f"flash backward kernels disagree with the plain "
                     f"backward ({dtype}, {name}; tolerance {tol} x "
                     "max(1, max |grad|))")
            if name != "training":
                continue
            again = cuda_ops.flash_attention_bwd(q, k, v, o, lse, do, dlse,
                                                 **kw)
            same = all(torch.equal(a, g) for a, g in zip(again, got))
            print(f"  flash bwd {str(dtype)[6:]:8s} {name:17s} second "
                  f"launch: dq, dk, dv {'bitwise equal' if same else 'DIFFER'}")
            if not same:
                fail(f"the backward kernels did not repeat bit for bit "
                     f"({dtype}, {name})")
            if dtype == torch.float32:
                errs = {"dq": case_err["dq"],
                        "dkv": max(case_err["dk"], case_err["dv"])}
    return errs


def make_texts(n, seed):
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     ,.",
                            dtype=np.uint8)
    return np.array([rng.choice(letters, size=int(rng.integers(
        TEXT_BYTES[0], TEXT_BYTES[1] + 1))).tobytes().decode()
        for _ in range(n)], dtype=object)


def run_slice():
    """Phase 4: the three stages at full width on the card; returns the
    kernel launches of the featurize + classify run."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.frame import Frame
    from tpudl_torch.ml import LMClassifier, LMFeaturizer, LMGenerator
    from tpudl_torch.obs import metrics
    from tpudl_torch.text import ByteTokenizer
    from tpudl_torch.zoo.transformer import TinyCausalLM

    spec = TinyCausalLM(VOCAB, DIM, HEADS, LAYERS, MAX_LEN, device="meta")
    t0 = time.perf_counter()
    weights = spec.init(SEED)
    n_params = sum(a.size for g in weights.values() for a in g.values())
    print(f"  init(seed={SEED}) of {n_params:,} f32 params: "
          f"{time.perf_counter() - t0:.1f} s")
    tok = ByteTokenizer()
    texts = make_texts(N_ROWS, SEED)
    frame = Frame({"text": texts})
    prompts = Frame({"text": np.array(PROMPTS, dtype=object)})
    common = dict(inputCol="text", model=spec, weights=weights,
                  tokenizer=tok)

    def stages(device):
        return (LMFeaturizer(outputCol="vec", batchSize=BATCH,
                             device=device, **common),
                LMClassifier(outputCol="label", classes=CLASSES,
                             batchSize=BATCH, device=device, **common),
                LMGenerator(outputCol="gen", maxNew=MAX_NEW,
                            device=device, **common))

    feat, clf, gen = stages("cuda")
    # warm-up: loads each stage's weights onto the card, wakes cuBLAS
    feat.transform(Frame({"text": texts[:2]}))
    clf.transform(Frame({"text": texts[:2]}))
    gen.transform(prompts)
    torch.cuda.synchronize()

    n_tokens = sum(len(t.encode()) + 1 for t in texts)   # + BOS
    reset_launch_counts()
    t0 = time.perf_counter()
    vec = feat.transform(frame)
    torch.cuda.synchronize()
    t_feat = time.perf_counter() - t0
    t0 = time.perf_counter()
    lab = clf.transform(frame)
    torch.cuda.synchronize()
    t_clf = time.perf_counter() - t0
    new_tokens = metrics.counter("lm.generate.tokens")
    n_new = new_tokens.value
    t0 = time.perf_counter()
    out = gen.transform(prompts)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    counts = dict(cuda_ops.launch_counts)
    launches = counts.pop("flash_attn_fwd")

    n_batches = 2 * -(-N_ROWS // BATCH)
    print(f"  flash kernel launches: {launches} (want {LAYERS} layers x "
          f"{n_batches} featurize+classify batches = {LAYERS * n_batches}; "
          f"generate adds none); backward kernels {counts} (want 0)")
    if launches != LAYERS * n_batches:
        fail("the main path did not launch the flash kernel once per "
             "decoder block per batch")
    if any(counts.values()):
        fail("serving launched a backward kernel")
    vecs = np.stack(list(vec["vec"]))
    if vecs.shape != (N_ROWS, DIM) or not np.isfinite(vecs).all():
        fail(f"featurizer output {vecs.shape}, finite="
             f"{bool(np.isfinite(vecs).all())}")
    labels = list(lab["label"])
    if len(labels) != N_ROWS or not set(labels) <= set(CLASSES):
        fail(f"classifier labels {set(labels)} not within {CLASSES}")
    n_new = int(new_tokens.value - n_new)
    print(f"  LMFeaturizer: {N_ROWS} rows, {n_tokens} tokens in "
          f"{t_feat:.3f} s = {N_ROWS / t_feat:.1f} rows/s, "
          f"{n_tokens / t_feat:.0f} tokens/s")
    print(f"  LMClassifier: {N_ROWS} rows in {t_clf:.3f} s = "
          f"{N_ROWS / t_clf:.1f} rows/s, {n_tokens / t_clf:.0f} tokens/s; "
          f"labels { {c: labels.count(c) for c in CLASSES} }")
    print(f"  LMGenerator: {len(PROMPTS)} prompts, maxNew={MAX_NEW}, "
          f"{n_new} new tokens in {t_gen:.3f} s = "
          f"{len(PROMPTS) / t_gen:.2f} rows/s, {n_new / t_gen:.1f} tokens/s")

    # two rows of each stage against the same stages on the CPU
    f_cpu, c_cpu, g_cpu = stages("cpu")
    two = Frame({"text": texts[:2]})
    cpu_vecs = np.stack(list(f_cpu.transform(two)["vec"]))
    err = float(np.abs(cpu_vecs - vecs[:2]).max())
    print(f"  featurizer card vs CPU, 2 rows: max abs {err:.3e} "
          f"(tolerance {FEATURE_ATOL}; features up to "
          f"{np.abs(cpu_vecs).max():.3e})")
    if not err <= FEATURE_ATOL:
        fail("featurizer disagrees with the CPU run")
    # the first row of each label the card gave, so the rows differ
    picks = [labels.index(c) for c in CLASSES if c in labels]
    rows = texts[picks]
    cpu_labels = list(c_cpu.transform(Frame({"text": rows}))["label"])
    card_labels = [labels[i] for i in picks]
    print(f"  classifier card vs CPU, rows {picks}: {card_labels} vs "
          f"{cpu_labels}")
    if cpu_labels != card_labels:
        fail("classifier disagrees with the CPU run")
    scores = {d: class_scores(weights, tok, rows, d) for d in ("cuda", "cpu")}
    err = float(np.abs(scores["cuda"] - scores["cpu"]).max())
    print(f"  class scores card vs CPU, rows {picks}: max abs {err:.3e} "
          f"(tolerance {SCORE_ATOL}; scores up to "
          f"{np.abs(scores['cpu']).max():.3e})")
    if not err <= SCORE_ATOL:
        fail("class scores disagree with the CPU run")
    cpu_gen = list(g_cpu.transform(Frame({"text": np.array(
        PROMPTS[:2], dtype=object)}))["gen"])
    print(f"  generator card vs CPU, 2 prompts: "
          f"{'equal' if cpu_gen == list(out['gen'][:2]) else 'DIFFER'}")
    if cpu_gen != list(out["gen"][:2]):
        fail(f"generator disagrees with the CPU run: {cpu_gen!r} vs "
             f"{list(out['gen'][:2])!r}")
    profile_run(f"one featurize batch ({BATCH} rows)",
                lambda: feat.transform(Frame({"text": texts[:BATCH]})))
    return launches


def class_scores(weights, tok, texts, device) -> np.ndarray:
    """What LMClassifier takes its argmax over: the last real position's
    logits at each class's leading token id, ``[rows, classes]``."""
    from tpudl_torch.text import PAD_ID, tokenize_pack
    from tpudl_torch.zoo.transformer import TinyCausalLM

    net = TinyCausalLM.from_jax_params(
        weights, vocab=VOCAB, dim=DIM, heads=HEADS, layers=LAYERS,
        max_len=MAX_LEN, device=device)
    ids = [int(tok.encode(c)[0]) for c in CLASSES]
    tokens = torch.from_numpy(tokenize_pack(tok, bos=True)(texts)).to(device)
    with torch.inference_mode():
        logits = net.apply(tokens)
    last = (tokens != PAD_ID).sum(dim=1) - 1
    rows = logits[torch.arange(len(texts), device=device), last]
    return rows[:, ids].double().cpu().numpy()


def reset_launch_counts():
    from tpudl_torch import cuda_ops

    for name in cuda_ops.launch_counts:
        cuda_ops.launch_counts[name] = 0


def profile_run(what, fn, top=6):
    """Where one run of ``fn`` spends the card's time: kernel time by
    name from torch.profiler, and its share of the run's wall time
    (measured under the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels:
        print(f"  profile of {what}: device time not measured (the "
              "profiler saw no kernels)")
        return
    print(f"  profile of {what}: wall {wall_ms:.1f} ms, kernels "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% busy)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3
        print(f"    {ms:8.2f} ms {100 * ms / busy_ms:5.1f}%  x{e.count:<4d} "
              f"{e.key[:90]}")


def training_rows(n_rows):
    """The training data: ``make_texts`` → ``ByteTokenizer`` →
    ``tokenize_pack(dense=True, seq_len=1025, eos=True)``, enough texts
    for ``n_rows`` full rows."""
    from tpudl_torch.text import ByteTokenizer, tokenize_pack

    pack = tokenize_pack(ByteTokenizer(), seq_len=TRAIN_SEQ, dense=True,
                         eos=True)
    # every text gives at least TEXT_BYTES[0] + 1 tokens (+ EOS)
    n_texts = -(-n_rows * TRAIN_SEQ // (TEXT_BYTES[0] + 1))
    rows = pack(make_texts(n_texts, SEED + 3))
    return rows[:n_rows]


def run_training():
    """Phase 4b: the training slice at full width on the card; returns
    the kernel launch counts of the timed steps."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.train import Trainer, adamw
    from tpudl_torch.zoo.transformer import TinyCausalLM, load_jax_params

    lm = TinyCausalLM(**TRAIN_ARCH, device="cuda")
    t0 = time.perf_counter()
    weights = lm.init(SEED)
    load_jax_params(lm, weights)
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"  init(seed={SEED}) of {n_params:,} f32 params: "
          f"{time.perf_counter() - t0:.1f} s")
    n_steps = WARMUP_STEPS + TIMED_STEPS + 1        # + the profiled step
    rows = training_rows(TRAIN_BATCH * n_steps)
    print(f"  data: {rows.shape[0]} dense-packed rows of {rows.shape[1]} "
          f"tokens, {TRAIN_BATCH} a step; attention at {list(TRAIN_SHAPE)} "
          "causal")

    def data_fn(step):
        return rows[step * TRAIN_BATCH:(step + 1) * TRAIN_BATCH]

    # warm-up: allocates the optimizer's moments, wakes cuBLAS
    _, opt, warm = Trainer(lm.loss_fn(), adamw(LR), log_every=1).fit(
        lm, data_fn, WARMUP_STEPS)
    trainer = Trainer(lm.loss_fn(), adamw(LR))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    _, opt, hist = trainer.fit(lm, lambda s: data_fn(WARMUP_STEPS + s),
                               TIMED_STEPS, opt_state=opt)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(cuda_ops.launch_counts)

    want = TRAIN_ARCH["layers"] * TIMED_STEPS
    print(f"  kernel launches over {TIMED_STEPS} steps: {counts} (want "
          f"{TRAIN_ARCH['layers']} layers x {TIMED_STEPS} steps = {want} "
          "of each)")
    if any(n != want for n in counts.values()):
        fail("a training step did not launch each kernel once per decoder "
             "block")
    loss0, last = warm[0]["loss"], hist[-1]["loss"]
    print(f"  loss: steps 1-{WARMUP_STEPS} {[h['loss'] for h in warm]}, "
          f"step {WARMUP_STEPS + TIMED_STEPS} {last}")
    if not (np.isfinite(last) and last < loss0):
        fail(f"the loss did not fall: step 1 {loss0}, last {last}")
    tokens = TIMED_STEPS * TRAIN_BATCH * (TRAIN_SEQ - 1)
    print(f"  {TIMED_STEPS} steps in {dt:.3f} s = {TIMED_STEPS / dt:.3f} "
          f"steps/s, {tokens / dt:.0f} tokens/s (predicted positions); "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    profile_run(f"one training step ({TRAIN_BATCH}x{TRAIN_SEQ} tokens)",
                lambda: trainer.fit(lm, lambda s: data_fn(n_steps - 1), 1,
                                    opt_state=opt), top=10)
    train_card_vs_cpu(weights, rows[:1, :CPU_TOKENS])
    return counts


def train_card_vs_cpu(weights, batch):
    """The full-width model from the same weights on one small batch,
    card vs CPU: the first loss, block 0's wq/wk/wv gradients (they come
    through the dq, dk and dv kernels) and the losses of 3 AdamW steps."""
    from tpudl_torch.train import Trainer, adamw
    from tpudl_torch.zoo.transformer import TinyCausalLM

    runs = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        m = TinyCausalLM.from_jax_params(weights, **TRAIN_ARCH,
                                         device=device)
        loss_fn = m.loss_fn()
        loss = loss_fn(m, torch.from_numpy(batch).to(m.device))
        loss.backward()
        grads = {w: m.blocks[0][w].grad.double().cpu().numpy()
                 for w in ("wq", "wk", "wv")}
        _, _, hist = Trainer(loss_fn, adamw(LR), log_every=1).fit(
            m, lambda s: batch, CPU_STEPS)
        runs[device] = (loss.item(), grads,
                        np.array([h["loss"] for h in hist]))
        print(f"  {device}: {CPU_STEPS + 1} forward+backward passes on "
              f"{list(batch.shape)} tokens in "
              f"{time.perf_counter() - t0:.1f} s")
    (loss_g, g_g, hist_g), (loss_c, g_c, hist_c) = runs["cuda"], runs["cpu"]
    loss_err = abs(loss_g - loss_c)
    g_scale = max(np.abs(g).max() for g in g_c.values())
    g_abs = max(np.abs(g_g[w] - g_c[w]).max() for w in g_c)
    g_err = g_abs / g_scale
    hist_err = float(np.abs(hist_g - hist_c).max())
    print(f"  training card vs CPU, {list(batch.shape)} tokens: first loss "
          f"{loss_g:.6f} vs {loss_c:.6f}, abs err {loss_err:.3e} (tolerance "
          f"{TRAIN_LOSS_ATOL}); block 0 wq/wk/wv grads max abs err "
          f"{g_abs:.3e} = {g_err:.3e} of the largest |grad| {g_scale:.3e} "
          f"(tolerance {TRAIN_GRAD_RTOL} of it); {CPU_STEPS}-step losses {hist_g.tolist()} vs "
          f"{hist_c.tolist()}, max abs err {hist_err:.3e} (tolerance "
          f"{TRAIN_STEPS_ATOL})")
    if not (loss_err <= TRAIN_LOSS_ATOL and g_err <= TRAIN_GRAD_RTOL
            and hist_err <= TRAIN_STEPS_ATOL):
        fail("training on the card disagrees with the CPU run")


def time_flash(dtype):
    """Phase 5: medians of 5 rounds, each round kernel/plain/library in
    turn, at the serving shape (causal)."""
    import torch.nn.functional as F

    from tpudl_torch import cuda_ops

    gen = torch.Generator().manual_seed(SEED + 1)
    q, k, v = (torch.randn(*SLICE_SHAPE, generator=gen).to("cuda", dtype)
               for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # [B, H, S, D]
    fns = {
        "ms": lambda: cuda_ops.flash_attention(q, k, v, causal=True),
        "plain_ms": lambda: cuda_ops.flash_attention_plain(q, k, v,
                                                           causal=True),
        "library_ms": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True),
    }
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    runs = {key: [] for key in fns}
    for _ in range(5):
        for key, fn in fns.items():
            runs[key].append(cuda_ms(fn))
    return {key: median(xs) for key, xs in runs.items()}


def time_bwd(dtype):
    """Phase 5, backward: medians of 5 rounds at the training shape
    (causal), each round in turn: the forward, the dq kernel alone, the
    dk/dv kernel alone, the whole backward (dlt, then both kernels), the
    plain backward, and ``scaled_dot_product_attention`` forward and
    forward+backward (its backward is the difference)."""
    import torch.nn.functional as F

    from tpudl_torch import cuda_ops

    gen = torch.Generator().manual_seed(SEED + 4)
    q, k, v, do = (torch.randn(*TRAIN_SHAPE, generator=gen).to("cuda", dtype)
                   for _ in range(4))
    dlse = torch.randn(*TRAIN_SHAPE[:3], generator=gen).to("cuda")
    mask = dict(causal=True, q_offset=0, k_offset=0)
    o, lse = cuda_ops.flash_attention(q, k, v, return_lse=True, causal=True)
    dlt = ((do.float() * o.float()).sum(dim=-1) - dlse).contiguous()
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))                      # [B, H, S, D]
    dot = do.transpose(1, 2)

    def library_fwd_bwd():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        torch.autograd.grad(out, (qt, kt, vt), dot)

    fns = {
        "fwd_ms": lambda: cuda_ops.flash_attention(q, k, v, causal=True),
        "dq_ms": lambda: cuda_ops._launch_bwd_dq(q, k, v, do, lse, dlt,
                                                 **mask),
        "dkv_ms": lambda: cuda_ops._launch_bwd_dkv(q, k, v, do, lse, dlt,
                                                   **mask),
        "bwd_ms": lambda: cuda_ops.flash_attention_bwd(
            q, k, v, o, lse, do, dlse, causal=True),
        "plain_ms": lambda: cuda_ops.flash_attention_bwd_plain(
            q, k, v, o, lse, do, dlse, causal=True),
        "library_fwd_ms": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True),
        "library_fwd_bwd_ms": library_fwd_bwd,
    }
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    runs = {key: [] for key in fns}
    for _ in range(5):
        for key, fn in fns.items():
            runs[key].append(cuda_ms(fn))
    t = {key: median(xs) for key, xs in runs.items()}
    t["library_bwd_ms"] = t["library_fwd_bwd_ms"] - t["library_fwd_ms"]
    return t


def image_structs(n, shape, seed):
    """``n`` seeded uint8 BGR image structs of ``shape`` (h, w, 3), built
    with numpy (no PIL, no libjpeg)."""
    from tpudl_torch.image import imageArrayToStruct

    rng = np.random.default_rng(seed)
    col = np.empty(n, dtype=object)
    col[:] = [imageArrayToStruct(rng.integers(0, 256, shape, dtype=np.uint8),
                                 origin=f"img{i}") for i in range(n)]
    return col


def image_flops(name, head, params=None):
    """Multiply-add work of one image through the model's products
    (convolutions and dense layers, 2 flops each), counted by
    ``torch.utils.flop_counter`` on meta tensors as ``head`` ("featurize"
    or "predict") runs them at the model's input size; elementwise work is
    not counted. ``params`` is the model's ``init(0)`` tree, drawn here if
    not given."""
    from torch.utils.flop_counter import FlopCounterMode

    from tpudl_torch.zoo import getKerasApplicationModel
    from tpudl_torch.zoo.convert import torch_layout

    model = getKerasApplicationModel(name)
    params = model.init(0) if params is None else params
    meta = {layer: {k: torch_layout(k, v).to("meta")
                    for k, v in leaves.items()}
            for layer, leaves in params.items()}
    x = torch.empty((1, *model.input_size, 3), device="meta")
    with FlopCounterMode(display=False) as fc:
        getattr(model, head)(meta, x)
    return fc.get_total_flops()


def timed_windows(fn, n):
    """Run ``fn`` (a transform of ``n`` rows that returns numpy)
    ``IMAGE_WINDOWS`` times on the host clock; returns each window's
    images/s and the first window's result."""
    rates, first = [], None
    for _ in range(IMAGE_WINDOWS):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - t0))
        first = out if first is None else first
    return rates, first


def image_rate_text(n, rates, flops, dtype_name, card):
    """images/s over the timed windows (median, least and most), achieved
    TFLOP/s at the median, and the bounds of the same work."""
    per_s = median(rates)
    text = (f"{n} images a window, {len(rates)} windows: median "
            f"{per_s:.1f} images/s (least {min(rates):.1f}, most "
            f"{max(rates):.1f}), {per_s * flops / 1e12:.2f} TFLOP/s of the "
            f"products at the median ({flops / 1e9:.3f} GFLOP an image)")
    if dtype_name == "float32":
        ffma = PEAK_OPS_PER_S["float32"] / flops
        tf32 = TF32_OPS_PER_S / TF32_PASSES / flops
        text += (f"; f32 FFMA bound {ffma:.0f} images/s (67 TFLOP/s), "
                 f"3xTF32 bound {tf32:.0f} images/s")
    else:
        text += (f"; bf16 tensor-core bound "
                 f"{PEAK_OPS_PER_S['bfloat16'] / flops:.0f} images/s")
    return text + f"; card {card}"


# aten op → the part of the batch it belongs to (profile split)
IMAGE_OP_GROUPS = (
    ("convolutions (cuDNN)", ("convolution",)),
    ("BN scale+shift", ("aten::mul", "aten::add", "aten::rsqrt",
                        "aten::neg")),
    ("ReLU", ("aten::relu", "aten::clamp_min")),
    ("concatenations", ("aten::cat",)),
    ("pooling", ("pool", "aten::mean")),
    ("prologue (cast, flip, resize, preprocess)",
     ("upsample", "aten::flip", "aten::div", "aten::sub", "aten::_to_copy")),
    ("host<->device copies", ("aten::copy_",)),
)


def profile_image_batch(dtype_name, fn, card):
    """Where one batch's card time goes: kernel time attributed to the
    aten op that launched it (``self_device_time_total``), grouped by
    ``IMAGE_OP_GROUPS``, and the card's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels:
        print("  profile: device time not measured (the profiler saw no "
              "kernels)")
        return
    print(f"  profile of one {dtype_name} batch ({IMAGE_BATCH} rows): wall "
          f"{wall_ms:.2f} ms, kernels {busy_ms:.2f} ms, card idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}% of the wall; card {card}")
    groups = {name: [0.0, 0] for name, _ in IMAGE_OP_GROUPS}
    other = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or \
                not e.self_device_time_total:
            continue
        for name, keys in IMAGE_OP_GROUPS:
            if any(k in e.key for k in keys):
                groups[name][0] += e.self_device_time_total / 1e3
                groups[name][1] += e.count
                break
        else:
            other[e.key] = other.get(e.key, 0.0) + \
                e.self_device_time_total / 1e3
    for name, (ms, count) in groups.items():
        print(f"    {ms:8.2f} ms {100 * ms / busy_ms:5.1f}%  x{count:<5d} "
              f"{name}")
    rest = sum(other.values())
    print(f"    {rest:8.2f} ms {100 * rest / busy_ms:5.1f}%  other "
          f"{sorted(other, key=other.get, reverse=True)[:4]}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        ms = e.self_device_time_total / 1e3
        print(f"      kernel {ms:8.2f} ms x{e.count:<4d} {e.key[:80]}")


def time_batch_fn(feat, frame):
    """The stage's per-batch function alone, on one batch already on the
    card (what the stage would reach if the executor cost nothing):
    ``IMAGE_WINDOWS`` windows of 5 calls, ms a call."""
    from tpudl_torch.ml.tf_image import _pack_image_structs

    fn = feat._batch_fn()
    batch = torch.from_numpy(_pack_image_structs(
        frame["image"][:IMAGE_BATCH])).to(feat._net().device)
    with torch.inference_mode():
        return [cuda_ms(lambda: fn(batch), reps=5)
                for _ in range(IMAGE_WINDOWS)]


def batch_fn_text(ms):
    return (f"{IMAGE_WINDOWS} windows of 5 calls: median {median(ms):.2f} ms"
            f" (least {min(ms):.2f}, most {max(ms):.2f}) = "
            f"{IMAGE_BATCH / median(ms) * 1e3:.1f} images/s")


def rel_err(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def run_image_slice(card):
    """Phase 6: the image slice at full width on the card — InceptionV3's
    leg, the legs of configs[1]'s models and of the rest of the zoo, the
    profiles of configs[1]'s models, and no attention kernel launched."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.frame import Frame

    # phase 1 switched cuDNN's TF32 off for the whole process; put it back
    # at PyTorch's default, so that the f32 checks below hold the stages'
    # own precision, as a user gets it
    torch.backends.cudnn.allow_tf32 = True
    print("  cuDNN TF32 at PyTorch's default (allowed) for this phase; the "
          "float32 stages switch it off for their own calls")
    reset_launch_counts()
    t0 = time.perf_counter()
    inception_leg(card)
    print(f"  {IMAGE_MODEL} leg: {time.perf_counter() - t0:.1f} s")
    profiles = [zoo_leg(name, card, IMAGE_ROWS, config1=True)
                for name in CONFIG1_MODELS]
    for name in ZOO_MODELS:
        zoo_leg(name, card, ZOO_ROWS, config1=False)
    # profiles last: a profiler session slows the timed runs after it
    for name, feats, frame in profiles:
        for dtype_name, feat in feats.items():
            print(f"  {name} {dtype_name}:")
            profile_image_batch(dtype_name, lambda: feat.transform(Frame(
                {"image": frame["image"][:IMAGE_BATCH]})), card)
    counts = dict(cuda_ops.launch_counts)
    print(f"  attention kernel launches across phase 6: {counts} (want 0)")
    if any(counts.values()):
        fail("the image path launched an attention kernel")


def inception_leg(card):
    """InceptionV3 at 299x299 and through the resize (PR 5's phase 6)."""
    import contextlib
    from unittest import mock

    from tpudl_torch.frame import Frame
    from tpudl_torch.ml import DeepImageFeaturizer, DeepImagePredictor
    from tpudl_torch.zoo import registry

    flops = image_flops(IMAGE_MODEL, "featurize")
    flops_pred = image_flops(IMAGE_MODEL, "predict")
    frame = Frame({"image": image_structs(IMAGE_ROWS, (299, 299, 3), SEED)})
    big = Frame({"image": image_structs(IMAGE_BIG_ROWS, (*IMAGE_BIG, 3),
                                        SEED + 1)})
    print(f"  data: {IMAGE_ROWS} uint8 BGR structs at 299x299 and "
          f"{IMAGE_BIG_ROWS} at {IMAGE_BIG[0]}x{IMAGE_BIG[1]}, batchSize "
          f"{IMAGE_BATCH}; work counted on meta tensors: {flops / 1e9:.3f} "
          f"GFLOP an image (featurize), {flops_pred / 1e9:.3f} (predict)")
    common = dict(inputCol="image", modelName=IMAGE_MODEL, weights="random",
                  batchSize=IMAGE_BATCH)
    feats = {}
    for dtype_name in ("float32", "bfloat16"):
        feat = DeepImageFeaturizer(outputCol="f", computeDtype=dtype_name,
                                   **common)
        t0 = time.perf_counter()
        feat.warmup(299, 299)
        feat.warmup(*IMAGE_BIG)
        torch.cuda.synchronize()
        print(f"  {dtype_name}: weights loaded and warmed in "
              f"{time.perf_counter() - t0:.1f} s")
        torch.cuda.reset_peak_memory_stats()
        rates, y = timed_windows(
            lambda: np.stack(list(feat.transform(frame)["f"])), IMAGE_ROWS)
        rates_big, y_big = timed_windows(
            lambda: np.stack(list(feat.transform(big)["f"])), IMAGE_BIG_ROWS)
        for name, arr in (("299x299", y), ("480x640", y_big)):
            if arr.shape[1:] != (2048,) or not np.isfinite(arr).all():
                fail(f"{dtype_name} features at {name}: shape {arr.shape},"
                     f" finite={bool(np.isfinite(arr).all())}")
        print(f"  DeepImageFeaturizer {dtype_name} at 299x299: "
              + image_rate_text(IMAGE_ROWS, rates, flops, dtype_name, card)
              + f"; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
              " GB")
        print(f"  DeepImageFeaturizer {dtype_name} at "
              f"{IMAGE_BIG[0]}x{IMAGE_BIG[1]} (resized on the card): "
              + image_rate_text(IMAGE_BIG_ROWS, rates_big, flops, dtype_name,
                                card))
        feats[dtype_name] = (feat, y, y_big)
        ms = time_batch_fn(feat, frame)
        print(f"  {dtype_name} per-batch function alone (batch already on "
              f"the card), {batch_fn_text(ms)}; the stage's median reached "
              f"{median(rates) * median(ms) / IMAGE_BATCH / 1e3:.2f} of it")

    pred = DeepImagePredictor(outputCol="p", decodePredictions=False,
                              **common)
    rows = Frame({"image": frame["image"][:IMAGE_BATCH]})
    pred.warmup(299, 299)
    torch.cuda.synchronize()
    rates, scores = timed_windows(
        lambda: np.stack(list(pred.transform(rows)["p"])), IMAGE_BATCH)
    check_softmax_rows("predictor", scores, IMAGE_BATCH, "float32")
    print("  DeepImagePredictor float32 at 299x299: "
          + image_rate_text(IMAGE_BATCH, rates, flops_pred, "float32", card))
    top = DeepImagePredictor(outputCol="p", decodePredictions=True, topK=3,
                             **common).transform(Frame(
                                 {"image": frame["image"][:2]}))["p"]
    if [len(r) for r in top] != [3, 3] or not all(
            isinstance(e, tuple) and len(e) == 3 for r in top for e in r):
        fail(f"decoded predictions have the wrong structure: {list(top)}")
    print(f"  decoded top-3 of row 0: {top[0]}")

    # card vs the same stage on the CPU
    f32, y, y_big = feats["float32"]
    n = IMAGE_CPU_ROWS
    t0 = time.perf_counter()
    cpu = DeepImageFeaturizer(outputCol="f", device="cpu", **common)
    y_cpu = np.stack(list(cpu.transform(Frame(
        {"image": frame["image"][:n]}))["f"]))
    y_cpu_big = np.stack(list(cpu.transform(Frame(
        {"image": big["image"][:2]}))["f"]))
    p_cpu = np.stack(list(DeepImagePredictor(
        outputCol="p", device="cpu", **common).transform(Frame(
            {"image": frame["image"][:2]}))["p"]))
    print(f"  CPU run of {n} + 2 featurize rows and 2 predict rows: "
          f"{time.perf_counter() - t0:.1f} s")
    errs = {"features 299x299": (rel_err(y[:n], y_cpu), y_cpu),
            f"features {IMAGE_BIG[0]}x{IMAGE_BIG[1]}": (
                rel_err(y_big[:2], y_cpu_big), y_cpu_big),
            "scores": (rel_err(scores[:2], p_cpu), p_cpu)}
    for name, (err, ref) in errs.items():
        print(f"  card vs CPU, {name}: max abs err {err:.3e} of max |y| "
              f"{np.abs(ref).max():.3e} (tolerance {IMAGE_CPU_RTOL})")
    if not all(err <= IMAGE_CPU_RTOL for err, _ in errs.values()):
        fail("the image stages on the card disagree with the CPU run")
    # what the check above would read had the stage left cuDNN's TF32 on
    with mock.patch.object(registry, "full_f32", contextlib.nullcontext):
        y_tf32 = np.stack(list(f32.transform(Frame(
            {"image": frame["image"][:n]}))["f"]))
    print(f"  for scale, the same {n} rows with the stage's TF32 switch "
          f"removed: {rel_err(y_tf32, y_cpu):.3e} of max |y|")
    _, yb, yb_big = feats["bfloat16"]
    err = max(rel_err(yb, y), rel_err(yb_big, y_big))
    print(f"  bf16 vs f32 on the card, {IMAGE_ROWS}+{IMAGE_BIG_ROWS} rows: "
          f"max abs err {err:.3e} of max |y| (tolerance {IMAGE_BF16_RTOL})")
    if not err <= IMAGE_BF16_RTOL:
        fail("bf16 features disagree with f32")

    read_images_leg(f32, card)
    # profiles last: a profiler session slows the timed runs after it,
    # which the per-batch function timed again after them shows
    for dtype_name, (feat, _, _) in feats.items():
        profile_image_batch(dtype_name, lambda: feat.transform(Frame(
            {"image": frame["image"][:IMAGE_BATCH]})), card)
    for dtype_name, (feat, _, _) in feats.items():
        print(f"  {dtype_name} per-batch function alone after the profiles,"
              f" {batch_fn_text(time_batch_fn(feat, frame))}")


def read_images_leg(feat, card):
    """``readImages`` over 64 JPEGs in a temporary directory, when PIL
    imports on this machine: images/s with host decode in the loop (each
    window reads the files anew), and 2 rows against the CPU stage on the
    same files."""
    import tempfile

    try:
        from PIL import Image
    except ImportError:
        print("  readImages leg skipped: PIL does not import here")
        return
    from tpudl_torch import native
    from tpudl_torch.image import readImages
    from tpudl_torch.ml import DeepImageFeaturizer

    native.available()   # build (or fail to build) the decoder untimed
    rng = np.random.default_rng(SEED + 2)
    with tempfile.TemporaryDirectory() as d:
        for i in range(IMAGE_BATCH):
            Image.fromarray(rng.integers(0, 256, (299, 299, 3),
                                         dtype=np.uint8)).save(
                f"{d}/img{i:03d}.jpg", quality=90)
        rates, y = timed_windows(lambda: np.stack(list(
            feat.transform(readImages(d))["f"])), IMAGE_BATCH)
        cpu = DeepImageFeaturizer(
            inputCol="image", outputCol="f", modelName=IMAGE_MODEL,
            batchSize=2, device="cpu").transform(readImages(d).head(2))
        err = rel_err(y[:2], np.stack(list(cpu["f"])))
    if y.shape != (IMAGE_BATCH, 2048) or not np.isfinite(y).all():
        fail(f"readImages features {y.shape}")
    print(f"  readImages + DeepImageFeaturizer float32 (decoder: "
          f"{'libjpeg' if native.available() else 'PIL'}), with decode: "
          f"{IMAGE_BATCH} JPEGs a window, {len(rates)} windows: median "
          f"{median(rates):.1f} images/s (least {min(rates):.1f}, most "
          f"{max(rates):.1f}); card vs CPU 2 rows {err:.3e} of max |y| "
          f"(tolerance {IMAGE_CPU_RTOL}); card {card}")
    if not err <= IMAGE_CPU_RTOL:
        fail("readImages features on the card disagree with the CPU run")


def check_softmax_rows(what, scores, n, dtype_name):
    if scores.shape != (n, 1000) or not np.isfinite(scores).all() or \
            np.abs(scores.sum(axis=1) - 1).max() > SOFTMAX_SUM_ATOL[
                dtype_name]:
        fail(f"{what} scores {scores.shape} are not finite softmax rows")


def perturbed_bn(params, seed=1):
    """``params`` with BN stats, shifts and scales (and EfficientNet's
    ``normalization`` mean and variance) moved away from 0 and 1, as the
    CPU tests perturb them, so that the outputs are not tiny. BN layers are
    the ones holding a ``moving_mean``, whatever their names."""
    rng = np.random.default_rng(seed)
    out = {}
    for layer, leaves in params.items():
        leaves = dict(leaves)
        if "moving_mean" in leaves:
            c = leaves["beta"].shape[0]
            leaves["moving_mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            leaves["moving_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            leaves["beta"] = rng.normal(0, 0.1, c).astype(np.float32)
            if "gamma" in leaves:
                leaves["gamma"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        if "variance" in leaves:
            c = leaves["mean"].shape[0]
            leaves["mean"] = rng.uniform(0.4, 0.5, c).astype(np.float32)
            leaves["variance"] = rng.uniform(0.04, 0.08, c).astype(np.float32)
        out[layer] = leaves
    return out


def zoo_leg(name, card, rows, *, config1):
    """One named model at its own input size, from seeded random weights:
    the featurizer in f32 and bf16 over ``rows`` seeded uint8 structs,
    ``IMAGE_WINDOWS`` windows each (median and spread) beside the counted
    work and the bounds; for configs[1]'s models the predictor likewise,
    for the others one predictor call; bf16 against f32; ``ZOO_CPU_ROWS``
    rows of each stage (features, and scores for configs[1]) against the
    CPU run with perturbed BN stats. Returns ``(name, {dtype:
    featurizer}, frame)`` for the profiles of configs[1]'s models."""
    import tempfile

    from tpudl_torch.frame import Frame
    from tpudl_torch.ml import DeepImageFeaturizer, DeepImagePredictor
    from tpudl_torch.zoo import getKerasApplicationModel, save_params_npz

    t_leg = time.perf_counter()
    model = getKerasApplicationModel(name)
    h, w = model.input_size
    params = model.init(0)
    n_params = sum(a.size for g in params.values() for a in g.values())
    flops = image_flops(name, "featurize", params)
    flops_pred = image_flops(name, "predict", params)
    frame = Frame({"image": image_structs(rows, (h, w, 3), SEED)})
    print(f"  {name}: {n_params:,} parameters, {h}x{w} input, "
          f"{model.feature_dim}-d features, '{model.preprocess_mode}' "
          f"preprocessing; {rows} uint8 BGR structs at {h}x{w}, batchSize "
          f"{IMAGE_BATCH}; {flops / 1e9:.3f} GFLOP an image (featurize), "
          f"{flops_pred / 1e9:.3f} (predict)", flush=True)
    common = dict(inputCol="image", modelName=name, weights="random",
                  batchSize=IMAGE_BATCH)
    feats, ys = {}, {}
    for dtype_name in ("float32", "bfloat16"):
        feat = DeepImageFeaturizer(outputCol="f", computeDtype=dtype_name,
                                   **common)
        feat.warmup(h, w)
        torch.cuda.synchronize()
        rates, y = timed_windows(
            lambda: np.stack(list(feat.transform(frame)["f"])), rows)
        if y.shape != (rows, model.feature_dim) or not np.isfinite(y).all():
            fail(f"{name} {dtype_name} features: shape {y.shape}, "
                 f"finite={bool(np.isfinite(y).all())}")
        print(f"  {name} DeepImageFeaturizer {dtype_name}: "
              + image_rate_text(rows, rates, flops, dtype_name, card))
        feats[dtype_name], ys[dtype_name] = feat, y
        if not config1:
            continue
        pred = DeepImagePredictor(outputCol="p", computeDtype=dtype_name,
                                  **common)
        pred.warmup(h, w)
        torch.cuda.synchronize()
        rates, scores = timed_windows(
            lambda: np.stack(list(pred.transform(frame)["p"])), rows)
        check_softmax_rows(f"{name} {dtype_name} predictor", scores, rows,
                           dtype_name)
        print(f"  {name} DeepImagePredictor {dtype_name}: "
              + image_rate_text(rows, rates, flops_pred, dtype_name, card))
        del pred
    if not config1:
        batch = Frame({"image": frame["image"][:IMAGE_BATCH]})
        scores = np.stack(list(DeepImagePredictor(
            outputCol="p", **common).transform(batch)["p"]))
        check_softmax_rows(f"{name} predictor", scores, IMAGE_BATCH,
                           "float32")
        print(f"  {name} DeepImagePredictor float32, one call of "
              f"{IMAGE_BATCH} rows: finite softmax rows (sums within "
              f"{np.abs(scores.sum(axis=1) - 1).max():.1e} of 1)")
    err = rel_err(ys["bfloat16"], ys["float32"])
    print(f"  {name} bf16 vs f32 on the card, {rows} rows: max abs err "
          f"{err:.3e} of max |y| {np.abs(ys['float32']).max():.3e} "
          f"(tolerance {IMAGE_BF16_RTOL})")
    if not err <= IMAGE_BF16_RTOL:
        fail(f"{name} bf16 features disagree with f32")

    # card vs CPU, f32, with perturbed BN stats
    t0 = time.perf_counter()
    cpu_rows = Frame({"image": frame["image"][:ZOO_CPU_ROWS]})
    stages = [("features", DeepImageFeaturizer)]
    if config1:
        stages.append(("scores", DeepImagePredictor))
    with tempfile.TemporaryDirectory() as d:
        path = save_params_npz(perturbed_bn(params), f"{d}/{name}.npz")
        del params
        for what, stage in stages:
            out = {device: np.stack(list(stage(
                inputCol="image", outputCol="y", modelName=name,
                weights=path, batchSize=ZOO_CPU_ROWS,
                device=device).transform(cpu_rows)["y"]))
                for device in ("cuda", "cpu")}
            err = rel_err(out["cuda"], out["cpu"])
            print(f"  {name} card vs CPU, {what} of {ZOO_CPU_ROWS} rows, "
                  f"perturbed BN stats: max abs err {err:.3e} of max |y| "
                  f"{np.abs(out['cpu']).max():.3e} (tolerance "
                  f"{IMAGE_CPU_RTOL})")
            if not err <= IMAGE_CPU_RTOL:
                fail(f"{name} {what} on the card disagree with the CPU run")
    print(f"  {name} leg: {time.perf_counter() - t_leg:.1f} s (card vs CPU "
          f"{time.perf_counter() - t0:.1f} s of it)", flush=True)
    return name, feats, frame


@contextlib.contextmanager
def executor_arm(arm):
    """The serial arm switches the pipelined executor off, as a user
    would (``TPUDL_FRAME_PREFETCH=0``); the others run with its defaults
    and their stage knobs."""
    saved = os.environ.get("TPUDL_FRAME_PREFETCH")
    if arm == "serial":
        os.environ["TPUDL_FRAME_PREFETCH"] = "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("TPUDL_FRAME_PREFETCH", None)
        else:
            os.environ["TPUDL_FRAME_PREFETCH"] = saved


def report_text(rep) -> str:
    """The stages, gauges and counts of one PipelineReport."""
    stages = ", ".join(f"{k} {v:.4f}" for k, v in
                       rep["stage_seconds"].items())
    calls = rep["stage_calls"]
    gauges = ", ".join(
        f"{g} mean {rep[g + '_mean']} max {rep[g + '_max']}"
        for g in ("queue_depth", "dispatch_inflight") if g + "_max" in rep)
    return (f"K={rep['prefetch_depth']} N={rep['prepare_workers']} "
            f"D={rep['dispatch_depth']} M={rep['fuse_steps']}; wall "
            f"{rep['wall_seconds']:.4f} s; stage s: {stages}; "
            f"{gauges or 'no gauges'}; dispatches {calls.get('dispatch', 0)}"
            f", fused {calls.get('fused_dispatches', 0)}, first dispatch "
            f"{calls.get('first_dispatch_s', 0):.4f} s, bytes prepared "
            f"{calls.get('bytes_prepared', 0)}; overlap efficiency "
            f"{rep.get('overlap_efficiency')}")


def idle_profile(fn):
    """(wall ms, card-busy ms, device events) of one run of ``fn`` under
    torch.profiler, tracing the card alone (recording host ops as well
    would slow the host-bound arms it measures): the busy time sums every
    kernel and copy the card ran, graph replays included."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    return wall_ms, busy, sum(e.count for e in dev)


def idle_text(what, wall_ms, busy_ms, n_events, card):
    if not n_events:
        return f"  {what}: card idle share not measured (no device events)"
    return (f"  {what}: one transform under the profiler, wall "
            f"{wall_ms:.1f} ms, card busy {busy_ms:.1f} ms ({n_events} "
            f"device events), card idle {100 * (1 - busy_ms / wall_ms):.1f}%"
            f"; card {card}")


def check_arm_output(what, y, y_serial, card):
    """Pipelined and fused outputs against the serial arm's: bitwise, or
    within IMAGE_CPU_RTOL of max |y| where a graph ran other kernels."""
    if y.shape != y_serial.shape or not np.isfinite(y).all():
        fail(f"{what}: output {y.shape}, finite={bool(np.isfinite(y).all())}")
    if np.array_equal(y, y_serial):
        return "bitwise equal to the serial arm"
    err = rel_err(y, y_serial)
    print(f"  {what}: not bitwise equal to the serial arm: {err:.3e} of max"
          f" |y| (tolerance {IMAGE_CPU_RTOL}); the CUDA graph was captured "
          "with other kernels than the eager calls launch (cuDNN picks its "
          f"algorithms per call); card {card}")
    if "fused" not in what or not err <= IMAGE_CPU_RTOL:
        fail(f"{what} disagrees with the serial arm")
    return f"{err:.3e} of max |y| off the serial arm"


def interleaved_windows(stages, run, n):
    """Each arm's transform timed IMAGE_WINDOWS times, the arms in turn
    within each window, so that the host's noise falls on all of them
    alike; returns {arm: rates}, {arm: first output}, {arm: last
    report}."""
    from tpudl_torch.obs import last_pipeline_report

    rates = {arm: [] for arm in stages}
    first, reports = {}, {}
    for _ in range(IMAGE_WINDOWS):
        for arm, stage in stages.items():
            with executor_arm(arm):
                t0 = time.perf_counter()
                y = run(stage)
                torch.cuda.synchronize()
                rates[arm].append(n / (time.perf_counter() - t0))
                reports[arm] = last_pipeline_report()
            first.setdefault(arm, y)
    return rates, first, reports


def executor_image_leg(name, dtype_name, card, profiles):
    """One (model, dtype) in the three arms: a warm transform each (which
    captures the fused arm's graph), IMAGE_WINDOWS windows with the arms
    in turn, the outputs held to the serial arm's, the reports, and the
    per-batch function's own rate; the profiles run later
    (``profiles``)."""
    from tpudl_torch.frame import Frame
    from tpudl_torch.ml import DeepImageFeaturizer
    from tpudl_torch.zoo import getKerasApplicationModel

    h, w = getKerasApplicationModel(name).input_size
    frame = Frame({"image": image_structs(IMAGE_ROWS, (h, w, 3), SEED)})
    stages, warm = {}, {}
    for arm, knobs in EXEC_ARMS.items():
        stages[arm] = DeepImageFeaturizer(
            inputCol="image", outputCol="f", modelName=name,
            weights="random", computeDtype=dtype_name,
            batchSize=IMAGE_BATCH, **knobs)
        with executor_arm(arm):
            t0 = time.perf_counter()
            stages[arm].transform(frame)
            torch.cuda.synchronize()
            warm[arm] = time.perf_counter() - t0
    rates, ys, reps = interleaved_windows(
        stages, lambda st: np.stack(list(st.transform(frame)["f"])),
        IMAGE_ROWS)
    for arm in EXEC_ARMS:
        verdict = ("the yardstick" if arm == "serial" else
                   check_arm_output(f"{name} {dtype_name} {arm}", ys[arm],
                                    ys["serial"], card))
        if arm == "fused" and not reps[arm]["stage_calls"].get(
                "fused_dispatches"):
            fail(f"{name} {dtype_name} fused arm ran no graph replay")
        r = rates[arm]
        print(f"  {name} {dtype_name} {arm}: warm transform "
              f"{warm[arm]:.2f} s; {IMAGE_ROWS} images a window, {len(r)} "
              f"windows (arms in turn): median {median(r):.1f} images/s "
              f"(least {min(r):.1f}, most {max(r):.1f}); {verdict}; card "
              f"{card}")
        print(f"    report of the last window: {report_text(reps[arm])}")
        profiles.append((f"{name} {dtype_name} {arm}", stages[arm], frame,
                         arm))
    ms = time_batch_fn(stages["serial"], frame)
    print(f"  {name} {dtype_name} per-batch function alone (batch already "
          f"on the card), {batch_fn_text(ms)}; card {card}")


def executor_lm_leg(card, profiles):
    """LMFeaturizer at serving width in the three arms: a counted run each
    (LAYERS flash forward launches a batch, the fused arm's graph replays
    included, after a warm transform that captures its graph), features
    bitwise equal to the serial arm's, and rows/s over IMAGE_WINDOWS
    windows with the arms in turn. Returns the launches of each arm's
    counted run."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.frame import Frame
    from tpudl_torch.ml import LMFeaturizer
    from tpudl_torch.obs import last_pipeline_report
    from tpudl_torch.text import ByteTokenizer
    from tpudl_torch.zoo.transformer import TinyCausalLM

    spec = TinyCausalLM(VOCAB, DIM, HEADS, LAYERS, MAX_LEN, device="meta")
    weights = spec.init(SEED)
    frame = Frame({"text": make_texts(N_ROWS, SEED)})
    n_batches = -(-N_ROWS // BATCH)
    stages, ys, launches, counted = {}, {}, {}, {}
    for arm, knobs in EXEC_ARMS.items():
        stages[arm] = feat = LMFeaturizer(
            inputCol="text", outputCol="vec", model=spec, weights=weights,
            tokenizer=ByteTokenizer(), batchSize=BATCH, **knobs)
        with executor_arm(arm):
            feat.transform(frame)          # loads, warms, captures
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            y = np.stack(list(feat.transform(frame)["vec"]))
            torch.cuda.synchronize()
            counted[arm] = (N_ROWS / (time.perf_counter() - t0),
                            last_pipeline_report())
            launches[arm] = dict(cuda_ops.launch_counts)
        n = launches[arm]["flash_attn_fwd"]
        if n != LAYERS * n_batches or launches[arm]["flash_attn_bwd_dq"] \
                or launches[arm]["flash_attn_bwd_dkv"]:
            fail(f"LMFeaturizer {arm}: launches {launches[arm]}, want "
                 f"{LAYERS} x {n_batches} forward and no backward")
        if arm == "fused" and not counted[arm][1]["stage_calls"].get(
                "fused_dispatches"):
            fail("LMFeaturizer fused arm ran no graph replay")
        if y.shape != (N_ROWS, DIM) or not np.isfinite(y).all():
            fail(f"LMFeaturizer {arm} output {y.shape}")
        ys[arm] = y
        if arm != "serial" and not np.array_equal(y, ys["serial"]):
            fail(f"LMFeaturizer {arm} features differ from the serial "
                 f"arm's by {float(np.abs(y - ys['serial']).max()):.3e}")
    rates, _, _ = interleaved_windows(stages, lambda st: st.transform(frame),
                                      N_ROWS)
    for arm in EXEC_ARMS:
        r = rates[arm]
        print(f"  LMFeaturizer {arm}: counted run {counted[arm][0]:.1f} "
              f"rows/s; {len(r)} windows (arms in turn): median "
              f"{median(r):.1f} rows/s (least {min(r):.1f}, most "
              f"{max(r):.1f}); flash forward launches "
              f"{launches[arm]['flash_attn_fwd']} = {LAYERS} x {n_batches} "
              f"batches{' (graph replays)' if arm == 'fused' else ''}; "
              f"{'the yardstick' if arm == 'serial' else 'bitwise equal to the serial arm'}"
              f"; card {card}")
        print(f"    report of the counted run: "
              f"{report_text(counted[arm][1])}")
        profiles.append((f"LMFeaturizer {arm}", stages[arm], frame, arm))
    return {arm: c["flash_attn_fwd"] for arm, c in launches.items()}


def executor_read_images_leg(card):
    """``readImages`` of EXEC_JPEGS seeded JPEGs with numPartition into the
    f32 InceptionV3 featurizer, serial against pipelined; every window
    reads and decodes the files anew (in the prepare pool when
    pipelined)."""
    import tempfile

    try:
        from PIL import Image
    except ImportError:
        print("  readImages leg skipped: PIL does not import here")
        return
    from tpudl_torch import native
    from tpudl_torch.image import readImages
    from tpudl_torch.ml import DeepImageFeaturizer

    decoder = "libjpeg" if native.available() else "PIL"
    rng = np.random.default_rng(SEED + 3)
    ys = {}
    with tempfile.TemporaryDirectory() as d:
        for i in range(EXEC_JPEGS):
            Image.fromarray(rng.integers(0, 256, (299, 299, 3),
                                         dtype=np.uint8)).save(
                f"{d}/img{i:04d}.jpg", quality=90)
        for arm in ("serial", "pipelined"):
            feat = DeepImageFeaturizer(inputCol="image", outputCol="f",
                                       modelName=IMAGE_MODEL,
                                       batchSize=IMAGE_BATCH)
            with executor_arm(arm):
                feat.warmup(299, 299)
                frame = readImages(d, numPartition=EXEC_PARTITIONS)
                workers = frame["image"].decode_workers
                rates, y = timed_windows(lambda: np.stack(list(
                    feat.transform(readImages(
                        d, numPartition=EXEC_PARTITIONS))["f"])),
                    EXEC_JPEGS)
            ys[arm] = y
            if y.shape[0] != EXEC_JPEGS or not np.isfinite(y).all():
                fail(f"readImages {arm} features {y.shape}")
            print(f"  readImages(numPartition={EXEC_PARTITIONS}) + "
                  f"DeepImageFeaturizer float32, {arm} (decoder {decoder}, "
                  f"decode_workers {workers}): {EXEC_JPEGS} JPEGs a window, "
                  f"{len(rates)} windows: median {median(rates):.1f} "
                  f"images/s (least {min(rates):.1f}, most "
                  f"{max(rates):.1f}); card {card}")
    if not np.array_equal(ys["pipelined"], ys["serial"]):
        fail("readImages pipelined features differ from the serial arm's")
    print("  readImages pipelined features bitwise equal to the serial arm")


def executor_precision_leg(card):
    """One f32 fused run with the caller's TF32 on for cuDNN and matmuls:
    the stage's graph must still compute in f32, within IMAGE_CPU_RTOL of
    max |y| of the CPU run."""
    from tpudl_torch.frame import Frame
    from tpudl_torch.ml import DeepImageFeaturizer
    from tpudl_torch.obs import last_pipeline_report

    frame = Frame({"image": image_structs(IMAGE_ROWS, (299, 299, 3), SEED)})
    common = dict(inputCol="image", outputCol="f", modelName=IMAGE_MODEL,
                  batchSize=IMAGE_BATCH)
    saved = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y = np.stack(list(DeepImageFeaturizer(
            fuseSteps=EXEC_FUSE, **common).transform(frame)["f"]))
        fused = last_pipeline_report()["stage_calls"].get(
            "fused_dispatches", 0)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved
    y_cpu = np.stack(list(DeepImageFeaturizer(device="cpu", **common)
                          .transform(Frame({"image": frame["image"][
                              :IMAGE_CPU_ROWS]}))["f"]))
    err = rel_err(y[:IMAGE_CPU_ROWS], y_cpu)
    print(f"  precision: {IMAGE_MODEL} float32 fused ({fused} graph replays) "
          f"with the caller's TF32 on, {IMAGE_CPU_ROWS} rows against the "
          f"CPU: {err:.3e} of max |y| {np.abs(y_cpu).max():.3e} (tolerance "
          f"{IMAGE_CPU_RTOL}); card {card}")
    if not fused or not err <= IMAGE_CPU_RTOL:
        fail("a fused f32 run under the caller's TF32 left f32")


def pool_study(card):
    """The pipelined arm's loss on host-bound bf16 cells, taken apart:
    each model's per-batch function through ``map_batches`` in the
    POOL_ARMS, the arms in turn in each of POOL_WINDOWS windows; images/s
    (median, least, most) and the report's host seconds a batch of
    ``prepare`` (on the pool or the consumer) and ``dispatch`` (the
    consumer's enqueue). Outputs bitwise equal to the serial arm's."""
    from tpudl_torch.frame import Frame
    from tpudl_torch.ml import DeepImageFeaturizer
    from tpudl_torch.ml.tf_image import _pack_image_structs
    from tpudl_torch.obs import last_pipeline_report
    from tpudl_torch.zoo import getKerasApplicationModel

    threads = torch.get_num_threads()
    print(f"  torch CPU threads {threads}, host cores {os.cpu_count()}")
    for name in POOL_MODELS:
        h, w = getKerasApplicationModel(name).input_size
        frame = Frame({"image": image_structs(IMAGE_ROWS, (h, w, 3), SEED)})
        fn = DeepImageFeaturizer(
            inputCol="image", outputCol="f", modelName=name,
            weights="random", computeDtype="bfloat16",
            batchSize=IMAGE_BATCH)._batch_fn()

        def run(arm):
            if arm.endswith("1 torch thread"):
                torch.set_num_threads(1)
            try:
                with torch.inference_mode():
                    out = frame.map_batches(
                        fn, ["image"], ["f"], batch_size=IMAGE_BATCH,
                        pack=_pack_image_structs, **POOL_ARMS[arm])
                torch.cuda.synchronize()
            finally:
                torch.set_num_threads(threads)
            return np.stack(list(out["f"])), last_pipeline_report()

        first = {arm: run(arm)[0] for arm in POOL_ARMS}  # warm
        rates = {arm: [] for arm in POOL_ARMS}
        per_batch = {arm: [] for arm in POOL_ARMS}
        for _ in range(POOL_WINDOWS):
            for arm in POOL_ARMS:
                t0 = time.perf_counter()
                _, rep = run(arm)
                rates[arm].append(IMAGE_ROWS / (time.perf_counter() - t0))
                per_batch[arm].append(rep["stage_seconds"])
        for arm in POOL_ARMS:
            if not np.array_equal(first[arm], first["serial"]):
                fail(f"pool study: {name} {arm} differs from the serial arm")
            r = rates[arm]
            n_b = IMAGE_ROWS // IMAGE_BATCH
            host = ", ".join(
                f"{k} {1e3 * median([s.get(k, 0.0) for s in per_batch[arm]]) / n_b:.2f}"
                for k in ("prepare", "dispatch", "dispatch_wait",
                          "infeed_wait", "d2h"))
            print(f"  {name} bfloat16 {arm}: median {median(r):.1f} "
                  f"images/s (least {min(r):.1f}, most {max(r):.1f}) over "
                  f"{POOL_WINDOWS} windows of {IMAGE_ROWS}; host ms a batch "
                  f"(median): {host}; card {card}", flush=True)


def run_executor(card):
    """Phase 7: the executor's arms under the image and LM stages, the
    readImages leg, the precision leg, then the idle-share profiles of
    every arm (profiles last: a profiler session slows the runs after
    it). Returns the flash forward launches of the LM arms."""
    t0 = time.perf_counter()
    profiles = []
    for name, dtype_name in EXEC_IMAGE:
        t_leg = time.perf_counter()
        executor_image_leg(name, dtype_name, card, profiles)
        print(f"  {name} {dtype_name} arms: "
              f"{time.perf_counter() - t_leg:.1f} s", flush=True)
    t_leg = time.perf_counter()
    launches = executor_lm_leg(card, profiles)
    print(f"  LMFeaturizer arms: {time.perf_counter() - t_leg:.1f} s",
          flush=True)
    t_leg = time.perf_counter()
    executor_read_images_leg(card)
    executor_precision_leg(card)
    print(f"  readImages and precision legs: "
          f"{time.perf_counter() - t_leg:.1f} s", flush=True)
    for what, stage, frame, arm in profiles:
        with executor_arm(arm):
            print(idle_text(what, *idle_profile(
                lambda: stage.transform(frame)), card))
    print(f"  phase 7: {time.perf_counter() - t0:.1f} s")
    return launches


# -- phase 8: ResNet50 training through HorovodRunner ----------------------
def resnet_loss(dtype):
    """bench.py's configs[3] loss: uint8 images normalized on the card,
    the clipped-log cross-entropy of ``predict``."""
    def loss_fn(net, x, y):
        x = (x.to(dtype) - 127.5) / 127.5
        logp = torch.log(torch.clamp(net.predict(x), 1e-7, 1.0))
        return -torch.mean(torch.sum(y * logp, dim=-1))

    return loss_fn


def resnet_train_loss(compute):
    """The loss a step trains: f32, or bf16 compute on the f32 masters."""
    from tpudl_torch.train import with_compute_dtype

    if compute == "float32":
        return resnet_loss(torch.float32)
    return with_compute_dtype(resnet_loss(torch.bfloat16), torch.bfloat16)


def resnet_net(ctx, params=None):
    from tpudl_torch.zoo.registry import ImageModel, getKerasApplicationModel

    model = getKerasApplicationModel("ResNet50")
    return ImageModel(model, params if params is not None else
                      model.init(SEED), device=ctx.device)


def resnet_batches(n, batch, seed, side=None):
    """bench.py's measure_train_step data: ``n`` uint8 image batches (at
    ``side``, default RESNET_SIDE) and one-hot labels over 1000 classes."""
    side = side or RESNET_SIDE
    rng = np.random.default_rng(seed)
    xs = [rng.integers(0, 256, size=(batch, side, side, 3),
                       dtype=np.uint8) for _ in range(n)]
    ys = [np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, batch)]
          for _ in range(n)]
    return xs, ys


def rate_train_fn(ctx, compute):
    """bench.py's measure_train_step train_fn: one warm fit step, then
    RESNET_WINDOWS windows of RESNET_WINDOW_STEPS steps; returns steps/s
    of each window and the all-reduce calls and bytes a step."""
    from tpudl_torch.obs import metrics
    from tpudl_torch.train import sgd

    net = resnet_net(ctx)
    xs, ys = resnet_batches(4, RESNET_BATCH, SEED)
    trainer = ctx.trainer(resnet_train_loss(compute), sgd(RESNET_LR))
    torch.cuda.reset_peak_memory_stats()

    def data(step):
        return xs[step % len(xs)], ys[step % len(ys)]

    trainer.fit(net, data, 1)  # warm: cuDNN picks its algorithms
    calls = metrics.counter("mesh.allreduce.calls").value
    nbytes = metrics.counter("mesh.allreduce.bytes").value
    rates = []
    for _ in range(RESNET_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.fit(net, data, RESNET_WINDOW_STEPS)
        torch.cuda.synchronize()
        rates.append(RESNET_WINDOW_STEPS / (time.perf_counter() - t0))
    steps = RESNET_WINDOWS * RESNET_WINDOW_STEPS
    return {"rates": rates,
            "calls": (metrics.counter("mesh.allreduce.calls").value
                      - calls) / steps,
            "bytes": (metrics.counter("mesh.allreduce.bytes").value
                      - nbytes) / steps,
            "params": sum(p.numel() for p in net.parameters()),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def card_vs_cpu_fn(ctx, params):
    """RESNET_CPU_STEPS f32 steps at RESNET_CPU_BATCH from ``params``:
    the losses and every leaf's update, in float64 on the host."""
    from tpudl_torch.train import sgd

    net = resnet_net(ctx, params)
    before = {k: v.detach().double().cpu() for k, v in
              net.state_dict().items()}
    xs, ys = resnet_batches(RESNET_CPU_STEPS, RESNET_CPU_BATCH, SEED + 1)
    _, _, hist = ctx.trainer(resnet_loss(torch.float32), sgd(RESNET_LR),
                             log_every=1).fit(
        net, lambda s: (xs[s], ys[s]), RESNET_CPU_STEPS)
    return (np.array([h["loss"] for h in hist]),
            {k: (v.detach().double().cpu() - before[k]).numpy()
             for k, v in net.state_dict().items()})


def resnet_first_gradient(params, device, dtype, name="ResNet50"):
    """The loss and every leaf's gradient of a first f32 (or float64) step
    of ``loss_fn`` through the named model ``name`` on RESNET_CPU_BATCH
    rows at the model's own input size, as float64 numpy."""
    from tpudl_torch.zoo.registry import ImageModel, getKerasApplicationModel

    model = getKerasApplicationModel(name)
    net = ImageModel(model, params, device=device, dtype=dtype)
    # card_vs_cpu_fn's first batch (at RESNET_SIDE for ResNet50)
    side = RESNET_SIDE if name == "ResNet50" else model.input_size[0]
    xs, ys = resnet_batches(RESNET_CPU_STEPS, RESNET_CPU_BATCH, SEED + 1,
                            side)
    loss = resnet_loss(dtype)(net, torch.from_numpy(xs[0]).to(device),
                              torch.from_numpy(ys[0]).to(device, dtype))
    loss.backward()
    return float(loss.detach()), {k: p.grad.double().cpu().numpy()
                                  for k, p in net.named_parameters()}


@contextlib.contextmanager
def training_layout(layout):
    """The zoo's training convolutions on ``layout`` memory: "NCHW" (the
    port's, NCHW-contiguous while autograd records) or "channels_last"
    (as before it, the inference layout kept for training too)."""
    from tpudl_torch.zoo import nn as zoo_nn

    saved = zoo_nn._training_memory
    if layout == "channels_last":
        zoo_nn._training_memory = lambda x, kernel: (x, kernel)
    try:
        yield
    finally:
        zoo_nn._training_memory = saved


def resnet_gradient_check(params, card, problems, name="ResNet50"):
    """A named model's first f32 step's gradients against float64 on the
    card: the card's f32 on NCHW memory (held), and on channels_last
    memory, the CPU's and the card's with cuDNN off (printed), as phase 9
    holds the Keras InceptionV3's."""
    t0 = time.perf_counter()
    ref_loss, ref = resnet_first_gradient(params, "cuda", torch.float64,
                                          name)
    top = max(np.abs(v).max() for v in ref.values())
    if not top > 0:
        problems.append(f"{name}'s float64 first step has no gradient")
        return
    runs = {"card f32, cuDNN, NCHW": ("cuda", True, "NCHW"),
            "card f32, cuDNN, channels_last (before)": ("cuda", True,
                                                        "channels_last"),
            "CPU f32": ("cpu", True, "NCHW"),
            "card f32, cuDNN off": ("cuda", False, "NCHW")}
    for what, (device, cudnn, layout) in runs.items():
        with torch.backends.cudnn.flags(enabled=cudnn), \
                training_layout(layout):
            loss, grads = resnet_first_gradient(params, device,
                                                torch.float32, name)
        errs = {k: np.abs(grads[k] - ref[k]).max() / top for k in ref}
        worst = max(errs, key=errs.get)
        held = what == "card f32, cuDNN, NCHW"
        print(f"  {name} first-step gradients, {what}, batch "
              f"{RESNET_CPU_BATCH}, perturbed BN, against float64 on the card"
              f" ({len(ref)} leaves, largest |g| {top:.4e}): loss "
              f"{loss - ref_loss:+.3e} off, gradients {errs[worst]:.3e} of "
              f"the largest at worst ({worst})"
              + (f" (limit {RESNET_GRAD_RTOL:g})" if held else
                 " (printed, not held)") + f"; card {card}", flush=True)
        if held and not errs[worst] <= RESNET_GRAD_RTOL:
            problems.append(f"{name} first-step gradients {errs[worst]:.3e}"
                            " of the largest off float64")
    print(f"  {name} gradient check: {time.perf_counter() - t0:.1f} s")


def band_batches():
    """bench.py's measure_resnet50_convergence set: class c is a bright
    horizontal band c of CURVE_CLASSES, CURVE_POOL batches cycled."""
    rng = np.random.default_rng(SEED)
    xs, ys = [], []
    for _ in range(CURVE_POOL):
        cls = rng.integers(0, CURVE_CLASSES, size=CURVE_BATCH)
        x = rng.integers(0, 96, size=(CURVE_BATCH, RESNET_SIDE, RESNET_SIDE,
                                      3), dtype=np.uint8)
        for i, c in enumerate(cls):
            x[i, c * RESNET_SIDE // CURVE_CLASSES:
              (c + 1) * RESNET_SIDE // CURVE_CLASSES] += 128
        xs.append(x)
        ys.append(np.eye(1000, dtype=np.float32)[cls])
    return xs, ys


def curve_fn(ctx):
    """bf16 compute on f32 masters over the band set; the fixed-batch eval
    loss (make_eval_step) at step 0 and every CURVE_EVERY steps."""
    from tpudl_torch.train import make_eval_step, sgd

    net = resnet_net(ctx)
    xs, ys = band_batches()
    loss = resnet_train_loss("bfloat16")
    trainer = ctx.trainer(loss, sgd(RESNET_LR))
    evaluate = make_eval_step(loss, mesh=ctx.mesh)
    curve = [(0, float(evaluate(net, xs[0], ys[0])))]
    t0 = time.perf_counter()
    for done in range(0, CURVE_STEPS, CURVE_EVERY):
        trainer.fit(net, lambda s, d=done: (xs[(d + s) % CURVE_POOL],
                                            ys[(d + s) % CURVE_POOL]),
                    CURVE_EVERY)
        curve.append((done + CURVE_EVERY, float(evaluate(net, xs[0],
                                                         ys[0]))))
    return curve, time.perf_counter() - t0


def checkpoint_fn(ctx, fail_at=None):
    """CKPT_STEPS steps of configs[3] under adam (so that the checkpoint
    holds the optimizer's moments too), saving every CKPT_EVERY steps;
    ``fail_at`` raises in data_fn at that step on the first attempt."""
    from tpudl_torch.train import adam

    net = resnet_net(ctx)
    xs, ys = resnet_batches(4, RESNET_BATCH, SEED)

    def data(step):
        if step == fail_at and ctx.attempt == 0:
            raise RuntimeError(f"injected failure at step {step}")
        return xs[step % len(xs)], ys[step % len(ys)]

    _, _, hist = ctx.trainer(resnet_loss(torch.float32), adam(1e-4),
                             log_every=1).fit(net, data, CKPT_STEPS)
    return ([h["step"] for h in hist],
            {k: v.detach().cpu().clone() for k, v in
             net.state_dict().items()})


TRAIN_OP_GROUPS = (  # (group, test on (ops from the launching one up, kernel))
    ("gradient all-reduce: flatten, NCCL, copy-back",
     lambda ops, k: "mesh.all_reduce_mean" in ops or "nccl" in k.lower()),
    ("host->device copies (the batch)", lambda ops, k: k.startswith(
        "Memcpy HtoD")),
    ("bf16 casts of the weights", lambda ops, k:
     "train.compute_dtype_cast" in ops),
    ("conv weight-gradient", lambda ops, k: "aten::convolution_backward"
     in ops and "wgrad" in k.lower()),
    ("conv data-gradient", lambda ops, k: "aten::convolution_backward" in ops
     and "dgrad" in k.lower()),
    ("conv backward, other kernels (layout transposes, GEMMs)",
     lambda ops, k: "aten::convolution_backward" in ops),
    ("conv forward", lambda ops, k: "aten::convolution" in ops),
    ("optimizer update", lambda ops, k: any("_foreach" in o or
                                            "Optimizer.step" in o
                                            for o in ops)),
    ("BN, ReLU, pooling, loss and other elementwise", lambda ops, k: True),
)


def profile_train_step(what, fn, card, op_groups=None):
    """One training step under torch.profiler: kernel time by
    ``op_groups`` (default TRAIN_OP_GROUPS; each kernel by the ops that
    launched it, from the innermost aten op up through its callers) and
    the card's idle share of the step's wall time."""
    op_groups = op_groups or TRAIN_OP_GROUPS
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {name: [0.0, 0] for name, _ in op_groups}
    names = {}
    for e in prof.events():
        if not getattr(e, "kernels", None):
            continue
        ops, up = [], e
        while up is not None:
            ops.append(up.name)
            up = up.cpu_parent
        for k in e.kernels:
            name = next(g for g, test in op_groups if test(ops, k.name))
            groups[name][0] += k.duration / 1e3
            groups[name][1] += 1
            names.setdefault(name, {}).setdefault(k.name, 0.0)
            names[name][k.name] += k.duration / 1e3
    busy_ms = sum(ms for ms, _ in groups.values())
    if not busy_ms:
        print(f"  profile of {what}: device time not measured (the "
              "profiler saw no kernels)")
        return
    print(f"  profile of {what}: wall {wall_ms:.2f} ms, kernels "
          f"{busy_ms:.2f} ms, card idle {100 * (1 - busy_ms / wall_ms):.1f}%"
          f" of the wall; card {card}")
    for name, (ms, count) in groups.items():
        top = sorted(names.get(name, {}).items(), key=lambda kv: -kv[1])[:2]
        print(f"    {ms:8.2f} ms {100 * ms / busy_ms:5.1f}%  x{count:<5d} "
              f"{name}  {[n[:60] for n, _ in top]}")


def profile_fn(ctx, card):
    """One warm f32 step and one warm bf16-compute step, each profiled."""
    from tpudl_torch.train import sgd

    net = resnet_net(ctx)
    xs, ys = resnet_batches(1, RESNET_BATCH, SEED)
    for compute in ("float32", "bfloat16"):
        trainer = ctx.trainer(resnet_train_loss(compute), sgd(RESNET_LR))
        trainer.fit(net, lambda s: (xs[0], ys[0]), 2)
        torch.cuda.synchronize()
        profile_train_step(
            f"one {compute}-compute step (batch {RESNET_BATCH}, "
            f"{RESNET_SIDE}x{RESNET_SIDE})",
            lambda: trainer.fit(net, lambda s: (xs[0], ys[0]), 1), card)


def data_parallel_fn(ctx, global_batch, steps, windows):
    """``steps`` f32 steps of configs[3] from init(0) on ``global_batch``
    rows (this rank takes its share), then ``windows`` timed windows of
    RESNET_WINDOW_STEPS steps; rank 0's losses, weights and steps/s."""
    from tpudl_torch.train import sgd

    net = resnet_net(ctx)
    xs, ys = resnet_batches(4, global_batch, SEED)
    trainer = ctx.trainer(resnet_loss(torch.float32), sgd(RESNET_LR),
                          log_every=1)

    def data(step):
        return xs[step % len(xs)], ys[step % len(ys)]

    _, _, hist = trainer.fit(net, data, steps)
    weights = {k: v.detach().double().cpu().numpy() for k, v in
               net.state_dict().items()}
    rates = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.fit(net, data, RESNET_WINDOW_STEPS)
        torch.cuda.synchronize()
        rates.append(RESNET_WINDOW_STEPS / (time.perf_counter() - t0))
    return np.array([h["loss"] for h in hist]), weights, rates


def run_data_parallel(card, n):
    """``--ranks N``: HorovodRunner(np=N) — N spawned ranks, one card
    each, NCCL — on a global batch of N x RESNET_BATCH against
    HorovodRunner(np=1) on the same global batch (3 f32 steps from
    init(0): losses and weights), and the N-rank rate against one rank
    at RESNET_BATCH."""
    from tpudl_torch.train import HorovodRunner

    t_phase = time.perf_counter()
    if torch.cuda.device_count() < n:
        fail(f"--ranks {n} needs {n} cards, have "
             f"{torch.cuda.device_count()}")
    g = n * RESNET_BATCH
    one_loss, one_w, _ = HorovodRunner(np=1).run(
        data_parallel_fn, global_batch=g, steps=3, windows=0)
    t0 = time.perf_counter()
    n_loss, n_w, n_rates = HorovodRunner(np=n).run(
        data_parallel_fn, global_batch=g, steps=3, windows=RESNET_WINDOWS)
    n_s = time.perf_counter() - t0
    _, _, one_rates = HorovodRunner(np=1).run(
        data_parallel_fn, global_batch=RESNET_BATCH, steps=1,
        windows=RESNET_WINDOWS)
    loss_err = float(np.abs(n_loss - one_loss).max())
    ref = resnet_net_init_state()
    d_one = {k: one_w[k] - ref[k] for k in ref}
    d_n = {k: n_w[k] - ref[k] for k in ref}
    scale = max(np.abs(d).max() for d in d_one.values())
    upd = max(np.abs(d_n[k] - d_one[k]).max() for k in ref) / scale
    print(f"  {n} ranks (np={n}, NCCL, one card each) against 1 rank on "
          f"the global batch of {g}, 3 f32 steps of sgd({RESNET_LR}) from "
          f"init(0): losses {n_loss.tolist()} vs {one_loss.tolist()}, max "
          f"abs err {loss_err:.3e} (tolerance {RESNET_CPU_LOSS_ATOL}); "
          f"updates max abs err {upd:.3e} of the largest |update| "
          f"{scale:.3e} (tolerance {RESNET_CPU_UPDATE_RTOL}); the {n}-rank "
          f"run took {n_s:.1f} s with its spawn; card {card}", flush=True)
    for what, rates, rows in ((f"{n} ranks", n_rates, g),
                              ("1 rank", one_rates, RESNET_BATCH)):
        print(f"  {what}, {RESNET_BATCH} rows a rank: {RESNET_WINDOWS} "
              f"windows of {RESNET_WINDOW_STEPS} steps: median "
              f"{median(rates):.3f} steps/s (least {min(rates):.3f}, most "
              f"{max(rates):.3f}) = {rows * median(rates):.1f} images/s; "
              f"card {card}", flush=True)
    print(f"  scaling: {median(n_rates) * g:.1f} / "
          f"{median(one_rates) * RESNET_BATCH:.1f} images/s = "
          f"{median(n_rates) * g / (median(one_rates) * RESNET_BATCH):.2f}x"
          f" on {n} cards; {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    if not (loss_err <= RESNET_CPU_LOSS_ATOL
            and upd <= RESNET_CPU_UPDATE_RTOL):
        fail(f"{n} ranks disagree with one rank on the global batch")


def resnet_net_init_state():
    """ResNet50's init(0) weights as the port's state_dict, float64."""
    from tpudl_torch.zoo.convert import torch_params
    from tpudl_torch.zoo.registry import getKerasApplicationModel

    tree = torch_params(getKerasApplicationModel("ResNet50").init(SEED))
    return {f"layers.{layer}.{k}": v.double().numpy()
            for layer, leaves in tree.items() for k, v in leaves.items()}


def run_resnet_training(card):
    """Phase 8: ResNet50 training (configs[3]) through HorovodRunner(np=1)
    on a one-rank NCCL group: rates in f32 and bf16 compute, no flash
    launch, card vs CPU, a falling eval loss, a gang restart from a
    checkpoint equal to an uninterrupted run, and a profile of each step
    (last: profiling slows the runs after it). Every check runs
    and prints; the phase fails at its end if any did not hold."""
    import shutil
    import tempfile

    from tpudl_torch import cuda_ops
    from tpudl_torch.obs import metrics
    from tpudl_torch.train import HorovodRunner
    from tpudl_torch.zoo.registry import getKerasApplicationModel

    t_phase = time.perf_counter()
    problems = []
    reset_launch_counts()
    gflop = RESNET_FLOPS * RESNET_BATCH / 1e9
    for compute in ("float32", "bfloat16"):
        for layout in ("NCHW", "channels_last"):
            t0 = time.perf_counter()
            with training_layout(layout):
                r = HorovodRunner(np=1).run(rate_train_fn, compute=compute)
            sps = r["rates"]
            peak = PEAK_OPS_PER_S["float32" if compute == "float32"
                                  else "bfloat16"]
            tflops = median(sps) * gflop / 1e3
            print(f"  {compute} compute on f32 masters, training "
                  f"convolutions on {layout} memory"
                  f"{' (now)' if layout == 'NCHW' else ' (before)'}, "
                  f"{r['params']:,} params, batch {RESNET_BATCH} at "
                  f"{RESNET_SIDE}x{RESNET_SIDE}: {RESNET_WINDOWS} windows of "
                  f"{RESNET_WINDOW_STEPS} steps: median {median(sps):.3f} "
                  f"steps/s (least {min(sps):.3f}, most {max(sps):.3f}) = "
                  f"{RESNET_BATCH * median(sps):.1f} images/s (least "
                  f"{RESNET_BATCH * min(sps):.1f}, most "
                  f"{RESNET_BATCH * max(sps):.1f}; earlier builds read "
                  f"{RESNET_CHANNELS_LAST_RATES[compute]} images/s on "
                  f"channels_last, "
                  f"NVIDIA H100 80GB HBM3, 700.00 W); {tflops:.2f} TFLOP/s "
                  f"of 3 x 7.71 GFLOP an image, "
                  f"{100 * tflops * 1e12 / peak:.2f}% of the "
                  f"{'f32 FFMA' if compute == 'float32' else 'bf16'} bound "
                  f"({peak / 1e12:.0f} TFLOP/s = "
                  f"{gflop * 1e9 / peak * 1e3:.2f} ms a step); all-reduce "
                  f"{r['calls']:.0f} call(s) and {r['bytes'] / 1e6:.1f} MB a"
                  f" step; peak memory {r['peak_gb']:.2f} GB; "
                  f"{time.perf_counter() - t0:.1f} s; card {card}",
                  flush=True)
            if r["calls"] < 1 or not all(np.isfinite(sps)):
                problems.append(f"{compute}: no all-reduce or no rate")

    params = perturbed_bn(getKerasApplicationModel("ResNet50").init(SEED),
                          seed=1)
    t0 = time.perf_counter()
    card_loss, card_d = HorovodRunner(np=1).run(card_vs_cpu_fn,
                                                params=params)
    cpu_loss, cpu_d = HorovodRunner(np=1, device="cpu").run(card_vs_cpu_fn,
                                                           params=params)
    loss_err = float(np.abs(card_loss - cpu_loss).max())
    scale = max(np.abs(d).max() for d in cpu_d.values())
    upd_abs = max(np.abs(card_d[k] - cpu_d[k]).max() for k in cpu_d)
    worst = max(cpu_d, key=lambda k: np.abs(card_d[k] - cpu_d[k]).max())
    print(f"  card vs CPU, f32, perturbed BN, {RESNET_CPU_STEPS} steps at "
          f"batch {RESNET_CPU_BATCH}: losses {card_loss.tolist()} vs "
          f"{cpu_loss.tolist()}, max abs err {loss_err:.3e} (tolerance "
          f"{RESNET_CPU_LOSS_ATOL}); updates p_after - p_before: max abs "
          f"err {upd_abs:.3e} = {upd_abs / scale:.3e} of the largest "
          f"|update| {scale:.3e} (tolerance {RESNET_CPU_UPDATE_RTOL}; worst "
          f"leaf {worst}); {time.perf_counter() - t0:.1f} s; card {card}",
          flush=True)
    if not (loss_err <= RESNET_CPU_LOSS_ATOL
            and upd_abs / scale <= RESNET_CPU_UPDATE_RTOL):
        problems.append("training on the card disagrees with the CPU run")
    resnet_gradient_check(params, card, problems)
    # on channels_last memory the named InceptionV3's gradients read
    # 8.93e-3 of float64, as the Keras InceptionV3's read 8.4e-2
    resnet_gradient_check(
        perturbed_bn(getKerasApplicationModel("InceptionV3").init(SEED),
                     seed=1), card, problems, "InceptionV3")

    curve, dt = HorovodRunner(np=1).run(curve_fn)
    print(f"  convergence (bench.py's band set, {CURVE_CLASSES} classes, "
          f"batch {CURVE_BATCH}, bf16 compute on f32 masters, "
          f"sgd({RESNET_LR})): fixed-batch eval loss "
          f"{[(s, round(v, 4)) for s, v in curve]}; {CURVE_STEPS} steps "
          f"and evals in {dt:.1f} s; card {card}", flush=True)
    if not (np.isfinite(curve[-1][1]) and curve[-1][1] < curve[0][1]):
        problems.append(f"the eval loss did not fall: {curve}")

    # resume-equivalence is bitwise under cudnn.deterministic (cuDNN may
    # otherwise pick nondeterministic convolution backward algorithms)
    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    ck_dir = tempfile.mkdtemp(prefix="tpudl-ckpt-")
    try:
        saves = metrics.histogram("train.checkpoint_save_seconds")
        restores = metrics.histogram("train.checkpoint_restore_seconds")
        n_save, n_restore = saves.count, restores.count
        restarts = metrics.counter("train.restarts").value
        t0 = time.perf_counter()
        _, straight = HorovodRunner(np=1).run(checkpoint_fn)
        steps, resumed = HorovodRunner(
            np=1, checkpoint_dir=ck_dir, save_every=CKPT_EVERY,
            max_restarts=1).run(checkpoint_fn, fail_at=CKPT_FAIL_AT)
        differ = [k for k in straight if not torch.equal(straight[k],
                                                         resumed[k])]
        save_s = list(saves.samples)[-(saves.count - n_save):]
        restore_s = list(restores.samples)[-(restores.count - n_restore):]
        size_mb = sum(os.path.getsize(os.path.join(ck_dir, f))
                      for f in os.listdir(ck_dir) if f.endswith(".npz"))
        print(f"  checkpoint and gang restart (adam, save_every="
              f"{CKPT_EVERY}, failure at step {CKPT_FAIL_AT} on attempt 0):"
              f" restarts {metrics.counter('train.restarts').value - restarts:.0f},"
              f" the resumed attempt ran steps {steps}; parameters and "
              f"buffers equal to the uninterrupted run's bit for bit: "
              f"{not differ} ({len(differ)} of {len(straight)} differ); "
              f"saves {[round(x, 3) for x in save_s]} s, restores "
              f"{[round(x, 3) for x in restore_s]} s, {size_mb / 1e6:.1f} MB "
              f"on disk (model + adam moments, {len(os.listdir(ck_dir)) - 1}"
              f" kept); {time.perf_counter() - t0:.1f} s; card {card}",
              flush=True)
        if differ or steps != list(range(CKPT_EVERY + 1, CKPT_STEPS + 1)):
            problems.append(f"the resumed run differs: {differ[:4]}")
    finally:
        torch.backends.cudnn.deterministic = saved_det
        shutil.rmtree(ck_dir, ignore_errors=True)

    HorovodRunner(np=1).run(profile_fn, card=card)
    counts = dict(cuda_ops.launch_counts)
    print(f"  flash kernel launches across phase 8: {counts} (want 0: "
          "ResNet50 training runs no attention)")
    if any(counts.values()):
        problems.append(f"a flash kernel launched: {counts}")
    print(f"  phase 8: {time.perf_counter() - t_phase:.1f} s; card {card}",
          flush=True)
    if problems:
        fail("phase 8: " + "; ".join(problems))
    return counts


# phase 9, the Keras surface: configs[4] (bench.py's
# measure_keras_transformer) and configs[2] (measure_estimator_inception),
# every .keras file written by the port (the card's machine has no keras)
KERAS_MLP_ROWS, KERAS_MLP_DIM, KERAS_MLP_BATCH = 65536, 100, 8192
KERAS_MLP_CPU_ROWS = 64
KERAS_FIXTURES = os.path.join("tests", "fixtures", "keras")
KERAS_H5 = os.path.join(KERAS_FIXTURES, "cnn.h5")   # bench.py's CNN, by keras
KERAS_JPEGS, KERAS_SIDE, KERAS_BATCH = 96, 299, 16
KERAS_CPU_ROWS, KERAS_CPU_BATCH = 8, 4     # 2 steps, card vs CPU
KERAS_TRANSFORM_ROWS = 16
KERAS_CURVE_EPOCHS = 3
LR_ROWS, LR_ITERS = 256, 100               # featurize then fit
# card vs CPU, f32 (relative to max |y|): the MLP is 3 products of at most
# 256 terms, InceptionV3 94 convolutions summed in other orders (phase 6
# read 1.3e-6 of max |y| for the named InceptionV3): phase 6's 2e-5
KERAS_CPU_RTOL = 2e-5
# training card vs CPU: the losses of 2 sgd steps as phase 8 holds them
# (2e-5). With adam, whose first update is ~lr·sign(g), a gradient within
# rounding of 0 can take the other sign: on the H100 its second loss read
# 1.9e-3 off the CPU's, so adam's losses are printed only.
# The first step's gradients against a float64 run on the card, relative
# to the largest: BN shifts sum a layer's gradient over up to 4×147×147
# positions with cancellation, so f32 reads far above its epsilon there.
# On the H100, with the Keras graph on NHWC (channels_last) memory, the
# card's f32 read 8.4e-2 (cuDNN's FFT engines on 17×17 layers) and the
# CPU's 1.1e-2; on NCHW memory, as the evaluator now runs, 1.9e-3 and
# 1.6e-3, and 6.0e-4 with cuDNN off. Card and CPU are held within 1e-2:
# about 5× their readings, and the NHWC fault fails it
KERAS_LOSS_ATOL = 2e-5
KERAS_GRAD_RTOL = 1e-2
# LogisticRegression probabilities, card vs CPU: 100 adam steps on the same
# features, f32 products in other orders
LR_PROB_ATOL = 1e-4
# the named models' own Keras files: Keras MobileNetV2 and EfficientNetB0
# bases through KerasImageFileTransformer at 224x224 (rows/s over
# IMAGE_WINDOWS windows, card vs CPU on 2 rows with perturbed BN at
# KERAS_CPU_RTOL), and the named stages with weights=<the base file>
# against the evaluator on the same file and rows
KERAS_APPS = ("mobilenet_v2", "efficientnet_b0")
KERAS_APP_SIDE, KERAS_APP_ROWS, KERAS_APP_BATCH = 224, 256, 64
KERAS_APP_CPU_ROWS = 2
KERAS_NAMED_ROWS = 16
# the zoo (channels_last, BN folded into one scale and shift) against the
# Keras evaluator (NCHW, BN as Keras computes it), both f32 with TF32 off
# on the card: two implementations of one function summing in other
# orders, held as phase 6 holds card vs CPU
KERAS_NAMED_RTOL = 2e-5
KERAS_H5_ROWS = 16


def keras_mlp_config():
    """configs[4]'s model as Keras 3 writes its ``config.json``: Sequential
    Dense 100→256→64→10, relu, relu, softmax (bench.py's
    measure_keras_transformer)."""
    policy = {"module": "keras", "class_name": "DTypePolicy",
              "config": {"name": "float32"}, "registered_name": None}
    shared = {**policy, "shared_object_id": 1}   # the model's own policy

    def dense(name, units, activation, fan_in):
        init = {"module": "keras.initializers", "registered_name": None}
        return {
            "module": "keras.layers", "class_name": "Dense",
            "config": {
                "name": name, "trainable": True,
                "dtype": policy if name == "dense" else shared,
                "units": units, "activation": activation, "use_bias": True,
                "kernel_initializer": {**init, "class_name": "GlorotUniform",
                                       "config": {"seed": None}},
                "bias_initializer": {**init, "class_name": "Zeros",
                                     "config": {}},
                "kernel_regularizer": None, "bias_regularizer": None,
                "kernel_constraint": None, "bias_constraint": None,
                "quantization_config": None},
            "registered_name": None,
            "build_config": {"input_shape": [None, fan_in]}}

    return {
        "module": "keras", "class_name": "Sequential",
        "config": {
            "name": "sequential", "trainable": True, "dtype": shared,
            "layers": [
                {"module": "keras.layers", "class_name": "InputLayer",
                 "config": {"batch_shape": [None, KERAS_MLP_DIM],
                            "dtype": "float32", "sparse": False,
                            "ragged": False, "name": "input_layer",
                            "optional": False},
                 "registered_name": None},
                dense("dense", 256, "relu", KERAS_MLP_DIM),
                dense("dense_1", 64, "relu", 256),
                dense("dense_2", 10, "softmax", 64)],
            "build_input_shape": [None, KERAS_MLP_DIM]},
        "registered_name": None,
        "build_config": {"input_shape": [None, KERAS_MLP_DIM]},
        "compile_config": {}}


def keras_app_config(fixture):
    """A committed Keras ``config.json`` fixture (written by keras with
    ``tests/torch_keras_models.py``): ``inception_v3_tl`` and
    ``xception_tl`` (the base, ``weights=None``, ``include_top=False``,
    ``pooling="avg"``, + a Dense(2) softmax head), ``mobilenet_v2`` and
    ``efficientnet_b0`` (the bare bases at 224x224)."""
    import gzip

    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, KERAS_FIXTURES, f"{fixture}.config.json.gz")
    with gzip.open(path, "rt") as f:
        return json.load(f)


def keras_inception_config():
    """configs[2]'s model, Keras InceptionV3 + a Dense(2) softmax head, as
    keras writes its ``config.json`` (the committed fixture)."""
    return keras_app_config("inception_v3_tl")


def keras_base_config(config):
    """A ``*_tl`` config without its ``head``: the base model, its output
    the head's input (the pooled features)."""
    import copy

    config = copy.deepcopy(config)
    layers = config["config"]["layers"]
    head = next(layer for layer in layers if layer["name"] == "head")
    layers.remove(head)
    arg = head["inbound_nodes"][0]["args"][0]
    config["config"]["output_layers"] = list(arg["config"]["keras_history"])
    return config


def keras_perturbed(weights, seed=1):
    """Keras-keyed ``weights`` with BN statistics, shifts and scales moved
    off 0 and 1 (as the CPU tests perturb them), so that a fold or a
    layout fault shows at a visible scale."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, v in weights.items():
        var = key.rsplit("/", 1)[1]
        if var in ("moving_mean", "beta"):
            v = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif var in ("moving_variance", "gamma"):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        out[key] = v
    return out


# each variable's initializer key in a layer's config
KERAS_INIT_KEYS = {"kernel": "kernel_initializer", "bias": "bias_initializer",
                   "depthwise_kernel": "depthwise_initializer",
                   "pointwise_kernel": "pointwise_initializer",
                   "gamma": "gamma_initializer", "beta": "beta_initializer",
                   "moving_mean": "moving_mean_initializer",
                   "moving_variance": "moving_variance_initializer"}
# the built-in initializers as keras's VarianceScaling(scale, mode, dist)
KERAS_SCALINGS = {"GlorotUniform": (1.0, "fan_avg", "uniform"),
                  "GlorotNormal": (1.0, "fan_avg", "truncated_normal"),
                  "HeUniform": (2.0, "fan_in", "uniform"),
                  "HeNormal": (2.0, "fan_in", "truncated_normal"),
                  "LecunUniform": (1.0, "fan_in", "uniform"),
                  "LecunNormal": (1.0, "fan_in", "truncated_normal")}


def keras_initial(spec, shape, rng):
    """One variable drawn as keras's initializer ``spec`` (its config
    entry) draws it, as float64 (keras/src/initializers: ``compute_fans``
    and ``VarianceScaling``)."""
    cls, c = spec["class_name"], spec.get("config") or {}
    if cls == "Zeros":
        return np.zeros(shape)
    if cls == "Ones":
        return np.ones(shape)
    if cls == "Constant":
        return np.full(shape, float(c["value"]))
    if cls in KERAS_SCALINGS:
        scale, mode, dist = KERAS_SCALINGS[cls]
    elif cls == "VarianceScaling":
        scale, mode, dist = c["scale"], c["mode"], c["distribution"]
    else:
        raise NotImplementedError(f"keras initializer {cls}")
    if len(shape) < 2:
        fan_in = fan_out = shape[0] if shape else 1
    else:
        receptive = int(np.prod(shape[:-2]))
        fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    n = {"fan_in": fan_in, "fan_out": fan_out,
         "fan_avg": (fan_in + fan_out) / 2}[mode]
    scale /= max(1.0, n)
    if dist == "uniform":
        lim = np.sqrt(3.0 * scale)
        return rng.uniform(-lim, lim, shape)
    if dist == "untruncated_normal":
        return rng.normal(0.0, np.sqrt(scale), shape)
    std = np.sqrt(scale) / 0.87962566103423978    # truncated at 2 std
    z = rng.normal(size=shape)
    while np.any(np.abs(z) > 2):
        bad = np.abs(z) > 2
        z[bad] = rng.normal(size=int(bad.sum()))
    return z * std


def keras_weights(config, seed):
    """Seeded weights for every variable of ``config`` as Keras initializes
    a model built with ``weights=None`` (``bench.py``'s models): each drawn
    from its layer's own initializer in the config (Glorot-uniform kernels,
    zero biases and shifts, BN moving means 0 and variances 1;
    EfficientNet's VarianceScaling), a Normalization's mean 0, variance 1
    and count 0. (With BN statistics moved off 0 and 1, as the CPU tests
    perturb them to test the fold, configs[2]'s adam fit saturates at the
    loss clip within two steps and no longer learns.)"""
    from tpudl_torch.ingest.kerasfile import variable_paths, variable_shapes

    rng = np.random.default_rng(seed)
    shapes = variable_shapes(config)
    out = {}
    for _group, layer, var, key in variable_paths(config):
        shape = shapes[key]
        if var == "count":
            out[key] = np.zeros(shape, np.int64)
            continue
        if var in ("mean", "variance"):       # Normalization
            v = np.zeros(shape) if var == "mean" else np.ones(shape)
        else:
            spec = layer["config"].get(KERAS_INIT_KEYS[var])
            if var == "kernel" and layer["class_name"] == "DepthwiseConv2D":
                spec = layer["config"]["depthwise_initializer"]
            v = keras_initial(spec, shape, rng)
        out[key] = v.astype(np.float32)
    return out


def keras_jpegs(directory, n, seed):
    """``measure_estimator_inception``'s images: ``n`` seeded 299×299
    JPEGs (quality 90), odd rows darkened in the top half and even rows
    in the bottom, and their one-hot labels."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    uris, labels = [], []
    for i in range(n):
        arr = rng.integers(0, 255, size=(KERAS_SIDE, KERAS_SIDE, 3),
                           dtype=np.uint8)
        if i % 2:
            arr[:150] //= 4
        else:
            arr[150:] //= 4
        p = os.path.join(directory, f"im{i}.jpg")
        Image.fromarray(arr).save(p, quality=90)
        uris.append(p)
        labels.append(np.eye(2, dtype=np.float32)[i % 2])
    return uris, labels


def keras_frame(uris, labels=None):
    from tpudl_torch.frame import Frame

    cols = {"uri": np.array(uris, dtype=object)}
    if labels is not None:
        lab = np.empty(len(labels), dtype=object)
        lab[:] = labels
        cols["label"] = lab
    return Frame(cols)


def keras_mlp_leg(directory, card, problems):
    """configs[4]: KerasTransformer over 65,536 seeded rows at batchSize
    8192, rows/s over 5 windows, and 64 rows card vs CPU."""
    from tpudl_torch.frame import Frame
    from tpudl_torch.ingest.kerasfile import save_keras_file
    from tpudl_torch.ml import KerasTransformer

    config = keras_mlp_config()
    path = save_keras_file(os.path.join(directory, "mlp.keras"), config,
                           keras_weights(config, SEED))
    data = np.random.default_rng(SEED).normal(
        size=(KERAS_MLP_ROWS, KERAS_MLP_DIM)).astype(np.float32)
    kt = KerasTransformer(inputCol="x", outputCol="y", modelFile=path,
                          batchSize=KERAS_MLP_BATCH)
    kt.transform(Frame({"x": data[:KERAS_MLP_BATCH]}))    # warm-up
    frame = Frame({"x": data})
    rates, out = timed_windows(
        lambda: np.stack(list(kt.transform(frame)["y"])), KERAS_MLP_ROWS)
    print(f"  configs[4] KerasTransformer MLP 100-256-64-10, "
          f"{KERAS_MLP_ROWS} rows at batchSize {KERAS_MLP_BATCH}, "
          f"{len(rates)} windows: median {median(rates):.1f} rows/s (least "
          f"{min(rates):.1f}, most {max(rates):.1f}); card {card}")
    if out.shape != (KERAS_MLP_ROWS, 10) or not np.isfinite(out).all() or \
            np.abs(out.sum(axis=1) - 1).max() > 1e-4:
        problems.append(f"MLP outputs {out.shape} are not softmax rows")
    cpu = KerasTransformer(inputCol="x", outputCol="y", modelFile=path,
                           batchSize=KERAS_MLP_BATCH, device="cpu")
    want = np.stack(list(cpu.transform(
        Frame({"x": data[:KERAS_MLP_CPU_ROWS]}))["y"]))
    err = rel_err(out[:KERAS_MLP_CPU_ROWS], want)
    print(f"  MLP card vs CPU, {KERAS_MLP_CPU_ROWS} rows: {err:.3e} of max "
          f"|y| (limit {KERAS_CPU_RTOL:g})")
    if not err <= KERAS_CPU_RTOL:
        problems.append(f"MLP card vs CPU {err:.3e}")


def keras_estimator(path, loader, device="cuda", **fit):
    from tpudl_torch.ml import KerasImageFileEstimator

    return KerasImageFileEstimator(
        inputCol="uri", outputCol="out", labelCol="label",
        imageLoader=loader, modelFile=path, kerasOptimizer="adam",
        kerasLoss="categorical_crossentropy", device=device,
        kerasFitParams={"epochs": 1, "batch_size": KERAS_BATCH, **fit})


def keras_fit_leg(model, path, frame, loader, card, problems, written):
    """configs[2]'s recipe on the Keras file ``path`` (``model`` names it):
    the fit cold and warm, its steps/s and losses, the train loop's own
    rate, and the written file read back bit for bit. Returns the
    estimator and its ``(X, y)``; the trained files go to ``written``."""
    from tpudl_torch.ingest.kerasfile import load_keras_file

    n_steps = -(-KERAS_JPEGS // KERAS_BATCH)
    est = keras_estimator(path, loader)
    for what in ("cold", "warm"):
        t0 = time.perf_counter()
        fitted = est.fit(frame)
        written.append(fitted.getModelFile())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"  KerasImageFileEstimator {model}, {KERAS_JPEGS} JPEGs "
              f"{KERAS_SIDE}x{KERAS_SIDE}, batch {KERAS_BATCH}, 1 epoch, "
              f"adam, {what}: fit {dt:.3f} s = {n_steps / dt:.3f} steps/s "
              f"end to end; step losses "
              f"{[round(v, 5) for v in fitted.history['step_loss']]}; "
              f"card {card}", flush=True)
    losses = fitted.history["step_loss"]
    if len(losses) != n_steps or not np.isfinite(losses).all():
        problems.append(f"{model} fit losses {losses}")
    # the fit's parts, and the train loop's own rate
    X, y = est._getNumpyFeaturesAndLabels(frame)
    gin = est._ingest()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, _epochs, _steps = est._train_one(gin, X, y)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trained = est._save_trained(gin, params)
    save_s = time.perf_counter() - t0
    written.append(trained)
    images_s = KERAS_BATCH * n_steps / train_s
    print(f"  {model} train loop alone: {n_steps} steps in {train_s:.3f} s "
          f"= {n_steps / train_s:.3f} steps/s ({images_s:.1f} images/s); "
          f"writing the trained .keras {os.path.getsize(trained)} bytes in "
          f"{save_s:.3f} s")
    _cfg, back = load_keras_file(trained)
    same = list(back) == list(params) and all(
        np.array_equal(back[k], params[k].detach().cpu().numpy()) and
        back[k].dtype == np.float32 for k in params)
    print(f"  trained file read back by load_keras_file: {len(back)} "
          f"variables, bit for bit equal to the trained params: {same}")
    if not same:
        problems.append(f"the trained {model} file does not read back equal")
    return est, X, y, fitted


def keras_estimator_leg(directory, card, problems, written):
    """configs[2] at full width: ``keras_fit_leg`` on InceptionV3 + head,
    card vs CPU on 2 steps, the returned transformer card vs CPU, and a
    3-epoch fit. The trained files the fits write are listed in
    ``written``."""
    from tpudl_torch.image.imageIO import createNativeImageLoader
    from tpudl_torch.ingest.kerasfile import save_keras_file
    from tpudl_torch.ml import KerasImageFileTransformer

    config = keras_inception_config()
    path = save_keras_file(os.path.join(directory, "inception_tl.keras"),
                           config, keras_weights(config, SEED))
    uris, labels = keras_jpegs(directory, KERAS_JPEGS, SEED)
    frame = keras_frame(uris, labels)
    loader = createNativeImageLoader(KERAS_SIDE, KERAS_SIDE,
                                     scale=1.0 / 255.0)
    est, X, y, model = keras_fit_leg("configs[2] InceptionV3+head", path,
                                     frame, loader, card, problems, written)
    keras_card_vs_cpu(path, loader, X, y, problems, "InceptionV3+head")
    # the returned transformer's outputs, card vs CPU
    head = keras_frame(uris[:KERAS_TRANSFORM_ROWS])
    outs = {}
    for device in ("cuda", "cpu"):
        tr = KerasImageFileTransformer(
            inputCol="uri", outputCol="out", modelFile=model.getModelFile(),
            imageLoader=loader, device=device)
        outs[device] = np.stack(list(tr.transform(head)["out"]))
    err = rel_err(outs["cuda"], outs["cpu"])
    print(f"  the returned transformer on {KERAS_TRANSFORM_ROWS} images, card"
          f" vs CPU: {err:.3e} of max |y| (limit {KERAS_CPU_RTOL:g}); "
          f"outputs {outs['cuda'].shape}")
    if outs["cuda"].shape != (KERAS_TRANSFORM_ROWS, 2) or \
            not err <= KERAS_CPU_RTOL:
        problems.append(f"transformer card vs CPU {err:.3e}")
    # a longer fit learns
    t0 = time.perf_counter()
    curve = keras_estimator(path, loader,
                            epochs=KERAS_CURVE_EPOCHS).fit(frame)
    written.append(curve.getModelFile())
    epoch_loss = curve.history["epoch_loss"]
    print(f"  {KERAS_CURVE_EPOCHS}-epoch fit in {time.perf_counter() - t0:.2f}"
          f" s: epoch mean losses {[round(v, 5) for v in epoch_loss]} (want "
          "the last below the first)")
    if not epoch_loss[-1] < epoch_loss[0]:
        problems.append(f"the {KERAS_CURVE_EPOCHS}-epoch loss did not fall")
    return est, X, y, frame, loader


def keras_first_gradient(path, loader, X, y, device, dtype):
    """The loss and every variable's gradient of the estimator's first
    step (categorical cross-entropy of the model's inference call) on the
    first ``KERAS_CPU_BATCH`` rows, as float64 numpy."""
    from tpudl_torch.device import full_f32
    from tpudl_torch.ml.losses import get_loss

    gin = keras_estimator(path, loader, device=device)._ingest()
    p = {k: torch.tensor(v, device=device, dtype=dtype, requires_grad=True)
         for k, v in gin.params.items()}
    xb = torch.tensor(X[:KERAS_CPU_BATCH], device=device, dtype=dtype)
    yb = torch.tensor(y[:KERAS_CPU_BATCH], device=device, dtype=dtype)
    with full_f32():
        loss = get_loss("categorical_crossentropy")(gin.make_fn()(p, xb), yb)
        loss.backward()
    return float(loss.detach()), {k: t.grad.double().cpu().numpy()
                                  for k, t in p.items()}


def keras_card_vs_cpu(path, loader, X, y, problems, model):
    """Training ``model`` on the card against the CPU: the losses of the
    estimator's first 2 sgd and adam steps at batch 4 (held for sgd; adam,
    whose first update is ~lr·sign(g), printed), and the first step's
    gradients of every variable against a float64 run on the card: the
    card's f32 and the CPU's (held), and the card's with cuDNN switched
    off (printed: the port's own arithmetic without cuDNN's engines)."""
    small = {"batch_size": KERAS_CPU_BATCH, "shuffle": False}
    for optimizer in ("sgd", "adam"):
        losses = {}
        for device in ("cuda", "cpu"):
            e = keras_estimator(path, loader, device=device, **small)
            e.setKerasOptimizer(optimizer)
            _p, _el, losses[device] = e._train_one(
                e._ingest(), X[:KERAS_CPU_ROWS], y[:KERAS_CPU_ROWS])
        err = float(np.abs(np.subtract(losses["cuda"], losses["cpu"])).max())
        held = optimizer == "sgd"
        print(f"  {model} card vs CPU, {optimizer}, "
              f"{KERAS_CPU_ROWS // KERAS_CPU_BATCH}"
              f" steps at batch {KERAS_CPU_BATCH}: losses {losses['cuda']} vs "
              f"{losses['cpu']}, largest difference {err:.3e}"
              + (f" (limit {KERAS_LOSS_ATOL:g})" if held else
                 " (printed, not held)"))
        if held and not err <= KERAS_LOSS_ATOL:
            problems.append(f"{model} estimator {optimizer} losses card "
                            f"vs CPU {err:.3e}")
    ref_loss, ref = keras_first_gradient(path, loader, X, y, "cuda",
                                         torch.float64)
    top = max(np.abs(v).max() for v in ref.values())
    runs = {"card f32, cuDNN": ("cuda", True), "CPU f32": ("cpu", True),
            "card f32, cuDNN off": ("cuda", False)}
    for what, (device, cudnn) in runs.items():
        with torch.backends.cudnn.flags(enabled=cudnn):
            loss, grads = keras_first_gradient(path, loader, X, y, device,
                                               torch.float32)
        errs = {k: np.abs(grads[k] - ref[k]).max() / top for k in ref}
        worst = max(errs, key=errs.get)
        held = what != "card f32, cuDNN off"
        print(f"  {model} first-step gradients, {what}, against float64 "
              "on the card"
              f" ({len(ref)} variables, largest |g| {top:.4e}): loss "
              f"{loss - ref_loss:+.3e} off, gradients {errs[worst]:.3e} of "
              f"the largest at worst ({worst})"
              + (f" (limit {KERAS_GRAD_RTOL:g})" if held else
                 " (printed, not held)"))
        if held and not errs[worst] <= KERAS_GRAD_RTOL:
            problems.append(f"{model} first-step gradients, {what}: "
                            f"{errs[worst]:.3e}")


def keras_profile_step(est, X, y, card):
    """One warm estimator step (batch 16) under torch.profiler."""
    from tpudl_torch.device import full_f32
    from tpudl_torch.ml.losses import get_loss, get_optimizer_dynamic

    gin = est._ingest()
    dev = torch.device("cuda")
    params = {k: torch.tensor(v, device=dev, requires_grad=True)
              for k, v in gin.params.items()}
    factory, _lr = get_optimizer_dynamic("adam")
    opt = factory(list(params.values()))
    fn, loss_fn = gin.make_fn(), get_loss("categorical_crossentropy")

    def step():
        with full_f32():
            xb = torch.from_numpy(X[:KERAS_BATCH]).to(dev)
            yb = torch.from_numpy(y[:KERAS_BATCH]).to(dev)
            opt.zero_grad(set_to_none=True)
            loss_fn(fn(params, xb), yb).backward()
            opt.step()

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    profile_train_step(f"one estimator step (InceptionV3+head, batch "
                       f"{KERAS_BATCH} at {KERAS_SIDE}x{KERAS_SIDE}, adam)",
                       step, card, KERAS_OP_GROUPS)


def keras_featurize_fit_leg(card, problems):
    """DeepImageFeaturizer("InceptionV3") features of 256 rows, then
    LogisticRegression(maxIter=100) on them, on the card and on the CPU."""
    from tpudl_torch.frame import Frame
    from tpudl_torch.image import imageArrayToStruct
    from tpudl_torch.ml import DeepImageFeaturizer, LogisticRegression

    rng = np.random.default_rng(SEED)
    col = np.empty(LR_ROWS, dtype=object)
    labels = np.arange(LR_ROWS) % 2
    for i in range(LR_ROWS):
        arr = rng.integers(0, 255, (KERAS_SIDE, KERAS_SIDE, 3), np.uint8)
        if labels[i]:
            arr[:150] //= 4
        else:
            arr[150:] //= 4
        col[i] = imageArrayToStruct(arr)
    feat = DeepImageFeaturizer(inputCol="image", outputCol="features",
                               modelName="InceptionV3", batchSize=64)
    frame = feat.transform(Frame({"image": col, "label": labels}))
    probs = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        lr = LogisticRegression(maxIter=LR_ITERS, device=device).fit(frame)
        dt = time.perf_counter() - t0
        out = lr.transform(frame)
        probs[device] = np.stack(list(out["probability"]))
        acc = float(np.mean(out["prediction"] == labels))
        print(f"  DeepImageFeaturizer(InceptionV3) -> LogisticRegression("
              f"maxIter={LR_ITERS}) on {LR_ROWS} rows, {device}: fit "
              f"{dt:.3f} s, loss {lr.history[0]:.5f} -> {lr.history[-1]:.5f},"
              f" training accuracy {acc:.3f}")
        if not lr.history[-1] < lr.history[0]:
            problems.append(f"LogisticRegression loss did not fall on "
                            f"{device}")
    err = float(np.abs(probs["cuda"] - probs["cpu"]).max())
    print(f"  LogisticRegression probabilities card vs CPU: {err:.3e} (limit "
          f"{LR_PROB_ATOL:g}); card {card}")
    if not err <= LR_PROB_ATOL:
        problems.append(f"LogisticRegression card vs CPU {err:.3e}")


def keras_xception_leg(directory, card, problems, written, frame, loader):
    """configs[2]'s recipe over Keras Xception + a Dense(2) softmax head at
    full width (configs[1]'s model): ``keras_fit_leg`` on the same 96
    JPEGs, then card vs CPU and the first step's gradients against
    float64 with BN statistics perturbed."""
    from tpudl_torch.ingest.kerasfile import save_keras_file

    config = keras_app_config("xception_tl")
    weights = keras_weights(config, SEED)
    path = save_keras_file(os.path.join(directory, "xception_tl.keras"),
                           config, weights)
    _est, X, y, _model = keras_fit_leg("Xception+head", path, frame, loader,
                                       card, problems, written)
    # held on perturbed BN statistics, as phase 8 holds the named models: at
    # Keras's init (BN shifts 0) one ReLU input of block14_sepconv2_bn read
    # 4.5e-13 in f32 and -1.1e-11 in float64 on the CPU, and that one
    # position put the channel's shift gradient 1.4e-2 of the largest off
    pert = save_keras_file(os.path.join(directory, "xception_tl_p.keras"),
                           config, keras_perturbed(weights))
    keras_card_vs_cpu(pert, loader, X, y, problems,
                      "Xception+head (perturbed BN)")


def keras_app_jpegs(directory, n, side, seed):
    """``n`` seeded ``side``x``side`` JPEGs (quality 90)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    uris = []
    for i in range(n):
        p = os.path.join(directory, f"app{side}_{i}.jpg")
        Image.fromarray(rng.integers(0, 255, (side, side, 3),
                                     dtype=np.uint8)).save(p, quality=90)
        uris.append(p)
    return uris


def keras_apps_leg(directory, card, problems):
    """Keras MobileNetV2 and EfficientNetB0 (the bases, from their own
    Keras files) through KerasImageFileTransformer at 224x224, f32, batch
    64: images/s over IMAGE_WINDOWS windows of KERAS_APP_ROWS JPEGs, and
    card vs CPU on 2 rows with BN statistics perturbed."""
    from tpudl_torch.image.imageIO import createNativeImageLoader
    from tpudl_torch.ingest.kerasfile import save_keras_file
    from tpudl_torch.ml import KerasImageFileTransformer

    uris = keras_app_jpegs(directory, KERAS_APP_ROWS, KERAS_APP_SIDE, SEED)
    frame = keras_frame(uris)
    loader = createNativeImageLoader(KERAS_APP_SIDE, KERAS_APP_SIDE,
                                     scale=1.0 / 255.0)
    for fixture in KERAS_APPS:
        t0 = time.perf_counter()
        config = keras_app_config(fixture)
        weights = keras_weights(config, SEED)
        path = save_keras_file(os.path.join(directory, f"{fixture}.keras"),
                               config, weights)
        kt = KerasImageFileTransformer(
            inputCol="uri", outputCol="out", modelFile=path,
            imageLoader=loader, batchSize=KERAS_APP_BATCH)
        kt.transform(keras_frame(uris[:KERAS_APP_BATCH]))       # warm-up
        rates, out = timed_windows(
            lambda: np.stack(list(kt.transform(frame)["out"])),
            KERAS_APP_ROWS)
        print(f"  {fixture} (Keras file, {len(weights)} variables) "
              f"KerasImageFileTransformer float32 at {KERAS_APP_SIDE}x"
              f"{KERAS_APP_SIDE}, batch {KERAS_APP_BATCH}, {KERAS_APP_ROWS} "
              f"JPEGs, {len(rates)} windows: median {median(rates):.1f} "
              f"images/s (least {min(rates):.1f}, most {max(rates):.1f}); "
              f"card {card}", flush=True)
        if out.shape != (KERAS_APP_ROWS, 1280) or not np.isfinite(out).all():
            problems.append(f"{fixture} outputs {out.shape}")
        pert = save_keras_file(os.path.join(directory, f"{fixture}_p.keras"),
                               config, keras_perturbed(weights))
        outs = {}
        head = keras_frame(uris[:KERAS_APP_CPU_ROWS])
        for device in ("cuda", "cpu"):
            outs[device] = np.stack(list(KerasImageFileTransformer(
                inputCol="uri", outputCol="out", modelFile=pert,
                imageLoader=loader, device=device).transform(head)["out"]))
        err = rel_err(outs["cuda"], outs["cpu"])
        print(f"  {fixture} card vs CPU, {KERAS_APP_CPU_ROWS} rows, perturbed"
              f" BN: {err:.3e} of max |y| {np.abs(outs['cpu']).max():.4g} "
              f"(limit {KERAS_CPU_RTOL:g}); {time.perf_counter() - t0:.1f} s",
              flush=True)
        if not err <= KERAS_CPU_RTOL:
            problems.append(f"{fixture} card vs CPU {err:.3e}")


def keras_named_leg(directory, card, problems):
    """The named stage against the Keras evaluator on one file: for
    Xception (the base of ``xception_tl``) and MobileNetV2, the features of
    ``DeepImageFeaturizer(modelName, weights=<the base .keras>)`` over
    image structs and of ``KerasImageFileTransformer`` over the same
    images as PNG files (the model's own size, so no resize; the loader
    applies the stage's ``x / 127.5 - 1``), both on the card, BN
    perturbed."""
    from PIL import Image

    from tpudl_torch.frame import Frame
    from tpudl_torch.image import imageArrayToStruct
    from tpudl_torch.ingest.kerasfile import save_keras_file
    from tpudl_torch.ml import DeepImageFeaturizer, KerasImageFileTransformer
    from tpudl_torch.zoo.registry import getKerasApplicationModel

    def loader(uri):
        rgb = np.asarray(Image.open(uri).convert("RGB"), dtype=np.float32)
        return rgb / 127.5 - 1.0

    bases = {"Xception": keras_base_config(keras_app_config("xception_tl")),
             "MobileNetV2": keras_app_config("mobilenet_v2")}
    rng = np.random.default_rng(SEED + 2)
    for name, config in bases.items():
        t0 = time.perf_counter()
        side = getKerasApplicationModel(name).input_size[0]
        path = save_keras_file(
            os.path.join(directory, f"{name}_base.keras"), config,
            keras_perturbed(keras_weights(config, SEED)))
        rgb = rng.integers(0, 256, (KERAS_NAMED_ROWS, side, side, 3),
                           dtype=np.uint8)
        uris, structs = [], np.empty(KERAS_NAMED_ROWS, dtype=object)
        for i, a in enumerate(rgb):
            uris.append(os.path.join(directory, f"{name}_{i}.png"))
            Image.fromarray(a).save(uris[-1])
            structs[i] = imageArrayToStruct(a[:, :, ::-1])    # stored BGR
        named = np.stack(list(DeepImageFeaturizer(
            inputCol="image", outputCol="f", modelName=name, weights=path,
            batchSize=KERAS_NAMED_ROWS).transform(
                Frame({"image": structs}))["f"]))
        graph = np.stack(list(KerasImageFileTransformer(
            inputCol="uri", outputCol="f", modelFile=path, imageLoader=loader,
            batchSize=KERAS_NAMED_ROWS).transform(keras_frame(uris))["f"]))
        err = rel_err(named, graph)
        print(f"  {name}: DeepImageFeaturizer(weights=<its Keras file>) vs "
              f"KerasImageFileTransformer on that file, {KERAS_NAMED_ROWS} "
              f"rows at {side}x{side}, both on the card: {err:.3e} of max |y|"
              f" {np.abs(graph).max():.4g} (limit {KERAS_NAMED_RTOL:g}); "
              f"features {named.shape}; {time.perf_counter() - t0:.1f} s; "
              f"card {card}", flush=True)
        if named.shape != graph.shape or not err <= KERAS_NAMED_RTOL:
            problems.append(f"{name} named stage vs evaluator {err:.3e}")


def keras_h5_leg(uris, card, problems):
    """The committed legacy ``.h5`` (bench.py's CNN, written by keras)
    through KerasImageFileTransformer, card vs CPU."""
    from tpudl_torch.image.imageIO import createNativeImageLoader
    from tpudl_torch.ml import KerasImageFileTransformer

    here = os.path.dirname(os.path.abspath(__file__))
    loader = createNativeImageLoader(32, 32, scale=1.0 / 255.0)
    frame = keras_frame(uris[:KERAS_H5_ROWS])
    outs = {}
    for device in ("cuda", "cpu"):
        outs[device] = np.stack(list(KerasImageFileTransformer(
            inputCol="uri", outputCol="out", modelFile=os.path.join(
                here, KERAS_H5), imageLoader=loader,
            device=device).transform(frame)["out"]))
    err = rel_err(outs["cuda"], outs["cpu"])
    print(f"  {KERAS_H5} (a legacy .h5) through KerasImageFileTransformer, "
          f"{KERAS_H5_ROWS} rows, card vs CPU: {err:.3e} of max |y| (limit "
          f"{KERAS_CPU_RTOL:g}); outputs {outs['cuda'].shape}; card {card}")
    if outs["cuda"].shape != (KERAS_H5_ROWS, 2) or not err <= KERAS_CPU_RTOL:
        problems.append(f"the .h5 card vs CPU {err:.3e}")


KERAS_OP_GROUPS = (  # (group, test on (ops from the launching one up, kernel))
    ("host->device copies (the batch)", lambda ops, k: k.startswith(
        "Memcpy HtoD")),
    ("conv weight-gradient", lambda ops, k: "aten::convolution_backward"
     in ops and "wgrad" in k.lower()),
    ("conv data-gradient", lambda ops, k: "aten::convolution_backward" in ops
     and "dgrad" in k.lower()),
    ("conv backward, other kernels (layout transposes, GEMMs)",
     lambda ops, k: "aten::convolution_backward" in ops),
    ("conv forward", lambda ops, k: "aten::convolution" in ops),
    ("optimizer update (adam)", lambda ops, k: any(
        "_foreach" in o or "Optimizer.step" in o for o in ops)),
    ("BN scale and shift, forward and backward (mul, add, rsqrt, neg)",
     lambda ops, k: any(o in ("aten::mul", "aten::add", "aten::rsqrt",
                              "aten::neg", "aten::sub") or
                        o.startswith(("MulBackward", "AddBackward",
                                      "RsqrtBackward", "NegBackward"))
                        for o in ops[:3])),
    ("ReLU, pooling, concatenation, loss and other elementwise",
     lambda ops, k: True),
)


def run_keras_surface(card):
    """Phase 9: the Keras surface at full width — configs[4]'s
    KerasTransformer, configs[2]'s KerasImageFileEstimator on InceptionV3
    and on Xception, the Keras MobileNetV2 and EfficientNetB0 files
    through KerasImageFileTransformer, the named stages with weights=<a
    Keras file> against the evaluator, a legacy .h5, featurize then
    LogisticRegression, no flash launch, and a profile of one estimator
    step (last). Every check runs and prints; the phase fails at its end
    if any did not hold. Returns the launch counts."""
    import shutil
    import tempfile

    from tpudl_torch import cuda_ops

    t_phase = time.perf_counter()
    problems = []
    reset_launch_counts()
    directory = tempfile.mkdtemp(prefix="tpudl_keras_smoke_")
    written = []      # the trained .keras files the fits write
    try:
        t0 = time.perf_counter()
        keras_mlp_leg(directory, card, problems)
        print(f"  configs[4] leg: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        est, X, y, frame, loader = keras_estimator_leg(directory, card,
                                                       problems, written)
        print(f"  configs[2] leg: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        keras_xception_leg(directory, card, problems, written, frame,
                           loader)
        print(f"  Xception+head leg: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        keras_apps_leg(directory, card, problems)
        keras_named_leg(directory, card, problems)
        keras_h5_leg(list(frame["uri"]), card, problems)
        print(f"  MobileNetV2, EfficientNetB0, named-stage and .h5 legs: "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        keras_featurize_fit_leg(card, problems)
        print(f"  featurize-then-fit leg: {time.perf_counter() - t0:.1f} s")
        counts = dict(cuda_ops.launch_counts)
        print(f"  attention kernel launches across phase 9: {counts} "
              "(want 0)")
        if any(counts.values()):
            problems.append("the Keras surface launched an attention kernel")
        keras_profile_step(est, X, y, card)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
        for path in written:
            os.remove(path)
    print(f"  phase 9: {time.perf_counter() - t_phase:.1f} s")
    if problems:
        fail("phase 9: " + "; ".join(problems))
    return counts


# phase 10, model selection and models as SQL UDFs, at full width from the
# .keras files the port writes: configs[2]'s InceptionV3 + head under
# CrossValidator (phase 9's 96 JPEGs, batch 16, adam), TFImageTransformer
# over 256 image structs at 299×299, the image and configs[4]'s MLP UDFs
# through sql, and the text UDFs at phase 4's serving width
SURFACE_LRS = (1e-3, 1e-4)
SURFACE_FOLDS = 2
TFIMAGE_ROWS, TFIMAGE_BATCH, TFIMAGE_CPU_ROWS = 256, 64, 16
CONV_IMAGE_ROWS = 64
SQL_LIMIT = 64
TEXT_UDF_MAX_NEW = 8


def keras_conv_image_config(height, width):
    """The ``conv_image`` test model as Keras 3 writes its ``config.json``
    (Sequential: one stride-2 ``same`` Conv2D(4, 3), sigmoid: an image
    out), at ``height`` × ``width`` × 3."""
    policy = {"module": "keras", "class_name": "DTypePolicy",
              "config": {"name": "float32"}, "registered_name": None}
    shape = [None, height, width, 3]
    init = {"module": "keras.initializers", "registered_name": None}
    conv = {
        "module": "keras.layers", "class_name": "Conv2D",
        "config": {
            "name": "conv2d", "trainable": True, "dtype": policy,
            "filters": 4, "kernel_size": [3, 3], "strides": [2, 2],
            "padding": "same", "data_format": "channels_last",
            "dilation_rate": [1, 1], "groups": 1, "activation": "sigmoid",
            "use_bias": True,
            "kernel_initializer": {**init, "class_name": "GlorotUniform",
                                   "config": {"seed": None}},
            "bias_initializer": {**init, "class_name": "Zeros",
                                 "config": {}},
            "kernel_regularizer": None, "bias_regularizer": None,
            "activity_regularizer": None, "kernel_constraint": None,
            "bias_constraint": None},
        "registered_name": None, "build_config": {"input_shape": shape}}
    return {
        "module": "keras", "class_name": "Sequential",
        "config": {
            "name": "sequential", "trainable": True,
            "dtype": {**policy, "shared_object_id": 1},
            "layers": [
                {"module": "keras.layers", "class_name": "InputLayer",
                 "config": {"batch_shape": shape, "dtype": "float32",
                            "sparse": False, "ragged": False,
                            "name": "input_layer", "optional": False},
                 "registered_name": None},
                conv],
            "build_input_shape": shape},
        "registered_name": None, "build_config": {"input_shape": shape},
        "compile_config": {}}


def cv_log_loss(frame):
    """The evaluator of phase 10's CrossValidator: mean categorical
    cross-entropy of the ``out`` column against ``label`` (lower is
    better)."""
    p = np.stack(list(frame["out"]))
    y = np.stack(list(frame["label"]))
    return float(-np.mean(np.sum(y * np.log(np.clip(p, 1e-7, 1.0)), axis=1)))


class TrialRecorder:
    """Wraps an estimator's ``fitMultiple`` (CrossValidator calls it on
    the estimator it holds): each trial's fold, index, seconds
    (``hpo.trial_seconds``), step losses and trained file, in completion
    order."""

    def __init__(self, est):
        self.fit_multiple = est.fitMultiple
        self.trials, self.files, self.fold = [], [], -1
        est.fitMultiple = self

    def __call__(self, frame, maps):
        from tpudl_torch.obs import metrics

        self.fold += 1
        seconds = metrics.histogram("hpo.trial_seconds")
        for i, model in self.fit_multiple(frame, maps):
            self.files.append(model.getModelFile())
            self.trials.append({"fold": self.fold, "index": i,
                                "seconds": seconds.samples[-1],
                                "steps": model.history["step_loss"]})
            yield i, model


def surface_estimator(path, loader, cls=None, **kw):
    from tpudl_torch.ml import KerasImageFileEstimator

    return (cls or KerasImageFileEstimator)(
        inputCol="uri", outputCol="out", labelCol="label",
        imageLoader=loader, modelFile=path, kerasOptimizer="adam",
        kerasLoss="categorical_crossentropy",
        kerasFitParams={"epochs": 1, "batch_size": KERAS_BATCH}, **kw)


def surface_grid(est):
    from tpudl_torch.ml import ParamGridBuilder

    return ParamGridBuilder().addGrid(est.kerasFitParams, [
        {"epochs": 1, "batch_size": KERAS_BATCH, "learning_rate": lr}
        for lr in SURFACE_LRS]).build()


def remove_files(paths):
    for p in paths:
        if os.path.exists(p):
            os.remove(p)
    paths.clear()


def surface_cv_leg(path, uris, labels, card, problems):
    """configs[2] under CrossValidator (2 learning rates × 2 folds): each
    trial's seconds and final loss, the completion order, avgMetrics,
    bestIndex and the fit's wall time, cold and warm; under
    cudnn.deterministic, the trials' losses against a plain loop of fit
    calls, and fitMultiple with a trial that fails once (transient) under
    a trialRetryPolicy against the same sweep without the failure."""
    from tpudl_torch.image.imageIO import createNativeImageLoader
    from tpudl_torch.jobs import RetryPolicy
    from tpudl_torch.ml import CrossValidator, FunctionEvaluator
    from tpudl_torch.obs import metrics

    frame = keras_frame(uris, labels)
    loader = createNativeImageLoader(KERAS_SIDE, KERAS_SIDE,
                                     scale=1.0 / 255.0)
    written = []

    def cross_validate(what):
        est = surface_estimator(path, loader)
        rec = TrialRecorder(est)
        cv = CrossValidator(estimator=est, estimatorParamMaps=surface_grid(
            est), evaluator=FunctionEvaluator(cv_log_loss,
                                              larger_is_better=False),
            numFolds=SURFACE_FOLDS, seed=SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = cv.fit(frame)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        written.extend(rec.files + [model.bestModel.getModelFile()])
        order = [(t["fold"], t["index"]) for t in rec.trials]
        trials = "; ".join(
            f"fold {t['fold']} lr {SURFACE_LRS[t['index']]:g}: "
            f"{t['seconds']:.3f} s, final loss {t['steps'][-1]:.5f}"
            for t in rec.trials)
        print(f"  CrossValidator {what}: KerasImageFileEstimator "
              f"(InceptionV3+head, {KERAS_JPEGS} JPEGs {KERAS_SIDE}x"
              f"{KERAS_SIDE}, batch {KERAS_BATCH}, 1 epoch, adam) over "
              f"learning rates {list(SURFACE_LRS)} x {SURFACE_FOLDS} folds:"
              f" {dt:.3f} s for the whole fit (trials, evaluation and the "
              f"refit on all rows); trials in completion order (fold, "
              f"index) {order}: {trials}; avgMetrics "
              f"{[round(m, 6) for m in model.avgMetrics]} (mean "
              f"cross-entropy), bestIndex {model.bestIndex}; card {card}",
              flush=True)
        if len(rec.trials) != SURFACE_FOLDS * len(SURFACE_LRS) or \
                not np.isfinite(model.avgMetrics).all() or \
                model.bestIndex not in range(len(SURFACE_LRS)):
            problems.append(f"CrossValidator {what}: {model.avgMetrics}")
        remove_files(written)
        return cv, rec

    try:
        cross_validate("cold")
        cross_validate("warm")
        saved_det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            cv, rec = cross_validate("under cudnn.deterministic")
            est = surface_estimator(path, loader)
            maps = surface_grid(est)
            folds = cv._folds(len(frame))
            same = []
            for t in rec.trials:
                train = np.ones(len(frame), dtype=bool)
                train[folds[t["fold"]]] = False
                model = est.fit(frame.filter_rows(train), maps[t["index"]])
                written.append(model.getModelFile())
                same.append(model.history["step_loss"] == t["steps"])
                remove_files(written)
            print(f"  a plain loop of fit(frame, pm) over the same maps and "
                  f"folds: per-trial step losses bit for bit equal to the "
                  f"CrossValidator's trials: {same}")
            if not all(same):
                problems.append("CrossValidator trials differ from plain fits")
            retries = metrics.counter("hpo.trial_retries")
            clean = dict(est.fitMultiple(frame, maps))
            written.extend(m.getModelFile() for m in clean.values())
            flaky = surface_estimator(
                path, loader, fails_once_estimator(),
                trialRetryPolicy=RetryPolicy(max_attempts=2, backoff_s=0.0))
            before = retries.value
            retried = dict(flaky.fitMultiple(frame, maps))
            written.extend(m.getModelFile() for m in retried.values())
            n_retries = retries.value - before
            equal = all(retried[i].history == clean[i].history
                        for i in clean)
            print(f"  fitMultiple on all {KERAS_JPEGS} rows with a "
                  f"trialRetryPolicy and a trial that fails once "
                  f"(OSError): hpo.trial_retries {n_retries:.0f} (want 1);"
                  f" every trial's losses bit for bit equal to the sweep "
                  f"without the failure: {equal}")
            if n_retries != 1 or not equal or sorted(retried) != \
                    list(range(len(maps))):
                problems.append("fitMultiple's retried sweep differs")
        finally:
            torch.backends.cudnn.deterministic = saved_det
    finally:
        remove_files(written)


def fails_once_estimator():
    """A KerasImageFileEstimator whose first trial raises a transient
    OSError once."""
    from tpudl_torch.ml import KerasImageFileEstimator

    class FailsOnce(KerasImageFileEstimator):
        failed = []

        def _trained_model(self, gin, X, y, device=None):
            if not self.failed:
                self.failed.append(True)
                raise OSError("transient read error (injected)")
            return super()._trained_model(gin, X, y, device)

    return FailsOnce


def tfimage_leg(directory, path, card, problems):
    """TFImageTransformer over configs[2]'s file: images/s beside the
    named InceptionV3 featurizer's, 16 rows against the CPU port, BGR
    against RGB on flipped input, and outputMode="image"."""
    from tpudl_torch.frame import Frame
    from tpudl_torch.image import imageArrayToStruct, imageStructToArray
    from tpudl_torch.ingest import TFInputGraph
    from tpudl_torch.ingest.kerasfile import save_keras_file
    from tpudl_torch.ml import DeepImageFeaturizer, TFImageTransformer

    gin = TFInputGraph.fromKeras(path)
    structs = image_structs(TFIMAGE_ROWS, (KERAS_SIDE, KERAS_SIDE, 3), SEED)
    frame = Frame({"image": structs})
    stages = {
        "TFImageTransformer(InceptionV3+head file)": TFImageTransformer(
            inputCol="image", outputCol="out", graph=gin,
            batchSize=TFIMAGE_BATCH),
        "DeepImageFeaturizer(InceptionV3)": DeepImageFeaturizer(
            inputCol="image", outputCol="out", modelName="InceptionV3",
            weights="random", batchSize=TFIMAGE_BATCH)}
    for st in stages.values():
        st.transform(Frame({"image": structs[:TFIMAGE_BATCH]}))   # warm
    rates, first, _ = interleaved_windows(
        stages, lambda st: np.stack(list(st.transform(frame)["out"])),
        TFIMAGE_ROWS)
    for what, r in rates.items():
        print(f"  {what}, f32, {TFIMAGE_ROWS} images {KERAS_SIDE}x"
              f"{KERAS_SIDE} at batch {TFIMAGE_BATCH}, {len(r)} windows "
              f"(the two in turn): median {median(r):.1f} images/s (least "
              f"{min(r):.1f}, most {max(r):.1f}); card {card}")
    out = first["TFImageTransformer(InceptionV3+head file)"]
    if out.shape != (TFIMAGE_ROWS, 2) or not np.isfinite(out).all():
        problems.append(f"TFImageTransformer outputs {out.shape}")
    cpu = TFImageTransformer(inputCol="image", outputCol="out", graph=gin,
                             batchSize=TFIMAGE_BATCH, device="cpu")
    want = np.stack(list(cpu.transform(
        Frame({"image": structs[:TFIMAGE_CPU_ROWS]}))["out"]))
    err = rel_err(out[:TFIMAGE_CPU_ROWS], want)
    print(f"  TFImageTransformer card vs CPU, {TFIMAGE_CPU_ROWS} rows: "
          f"{err:.3e} of max |y| (limit {IMAGE_CPU_RTOL:g})")
    if not err <= IMAGE_CPU_RTOL:
        problems.append(f"TFImageTransformer card vs CPU {err:.3e}")
    head = structs[:TFIMAGE_BATCH]
    flipped = np.empty(len(head), dtype=object)
    flipped[:] = [imageArrayToStruct(np.ascontiguousarray(
        imageStructToArray(s)[..., ::-1])) for s in head]
    by_order = {}
    for order, col in (("BGR", head), ("RGB", flipped)):
        st = TFImageTransformer(inputCol="image", outputCol="out",
                                graph=gin, channelOrder=order,
                                batchSize=TFIMAGE_BATCH)
        by_order[order] = np.stack(list(st.transform(
            Frame({"image": col}))["out"]))
    same = np.array_equal(by_order["BGR"], by_order["RGB"])
    print(f"  channelOrder='BGR' equals 'RGB' on channel-flipped input, "
          f"{len(head)} rows, bit for bit: {same}")
    if not same:
        problems.append("channelOrder BGR differs from RGB on flipped input")
    config = keras_conv_image_config(KERAS_SIDE, KERAS_SIDE)
    conv = save_keras_file(os.path.join(directory, "conv_image.keras"),
                           config, keras_weights(config, SEED))
    imgs = TFImageTransformer(
        inputCol="image", outputCol="out", outputMode="image",
        graph=TFInputGraph.fromKeras(conv), batchSize=TFIMAGE_BATCH
    ).transform(Frame({"image": structs[:CONV_IMAGE_ROWS]}))["out"]
    side = -(-KERAS_SIDE // 2)
    shapes = {(s["height"], s["width"], s["nChannels"]) for s in imgs}
    arrays = np.stack([imageStructToArray(s) for s in imgs])
    print(f"  outputMode='image' (Conv2D(4, 3, strides 2, same, sigmoid)), "
          f"{CONV_IMAGE_ROWS} rows: struct shapes {sorted(shapes)} (want "
          f"{(side, side, 4)}), values in [{arrays.min():.4f}, "
          f"{arrays.max():.4f}]")
    if shapes != {(side, side, 4)} or not (
            (arrays >= 0) & (arrays <= 1)).all():
        problems.append(f"outputMode='image' structs {sorted(shapes)}")
    return gin, structs


def sql_image_leg(path, gin, structs, card, problems):
    """registerKerasImageUDF through sql with WHERE and LIMIT: exactly
    SQL_LIMIT rows featurized, equal bit for bit to TFImageTransformer on
    the same rows; then a GROUP BY/AVG over the UDF's output."""
    from tpudl_torch.frame import Frame, sql
    from tpudl_torch.ml import TFImageTransformer
    from tpudl_torch.obs import metrics
    from tpudl_torch.udf import registerKerasImageUDF, unregister_udf

    labels = np.arange(len(structs)) % 2
    images = Frame({"image": structs, "label": labels})
    registerKerasImageUDF("inception_udf", path, batch_size=TFIMAGE_BATCH)
    try:
        rows = metrics.counter("udf.inception_udf.rows")
        sql(f"SELECT inception_udf(image) AS preds FROM images LIMIT "
            f"{TFIMAGE_BATCH}", {"images": images})        # warm
        before = rows.value
        q = (f"SELECT inception_udf(image) AS preds FROM images WHERE "
             f"label = 1 LIMIT {SQL_LIMIT}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds = np.stack(list(sql(q, {"images": images})["preds"]))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = rows.value - before
        chosen = images.filter_rows(labels == 1).limit(SQL_LIMIT)
        want = np.stack(list(TFImageTransformer(
            inputCol="image", outputCol="o", graph=gin,
            batchSize=TFIMAGE_BATCH).transform(chosen)["o"]))
        same = preds.shape == want.shape and np.array_equal(preds, want)
        print(f"  sql(\"{q}\") over {len(structs)} rows: {dt:.3f} s, the UDF"
              f" featurized {n:.0f} rows (want {SQL_LIMIT}); equal bit for "
              f"bit to TFImageTransformer on the same rows: {same}; card "
              f"{card}")
        if n != SQL_LIMIT or not same:
            problems.append(f"image UDF through sql: {n} rows, equal {same}")
        scored = sql(f"SELECT inception_udf(image) AS preds, label FROM "
                     f"images LIMIT {2 * SQL_LIMIT}", {"images": images})
        p1 = np.array([v[1] for v in scored["preds"]], dtype=np.float64)
        grouped = sql("SELECT label, COUNT(*) AS n, AVG(p1) AS mean_p1 FROM "
                      "scored GROUP BY label ORDER BY label", {
                          "scored": Frame({"label": scored["label"],
                                           "p1": p1})})
        lab = np.asarray(scored["label"])
        want = [float(np.mean(p1[lab == k])) for k in (0, 1)]
        err = float(np.abs(np.asarray(grouped["mean_p1"], dtype=np.float64)
                           - want).max())
        print(f"  GROUP BY label over the UDF's output: labels "
              f"{[int(v) for v in grouped['label']]}, counts "
              f"{[int(v) for v in grouped['n']]}, AVG(preds[1]) "
              f"{[round(float(v), 6) for v in grouped['mean_p1']]} "
              f"({err:.1e} off numpy's mean)")
        if list(grouped["n"]) != [SQL_LIMIT, SQL_LIMIT] or not err <= 1e-12:
            problems.append("GROUP BY/AVG over the UDF's output")
    finally:
        unregister_udf("inception_udf")


def sql_mlp_leg(directory, card, problems):
    """configs[4]'s MLP as makeGraphUDF through sql, rows/s beside
    KerasTransformer's (in turn), outputs equal bit for bit."""
    from tpudl_torch.frame import Frame, sql
    from tpudl_torch.ingest import TFInputGraph
    from tpudl_torch.ingest.kerasfile import save_keras_file
    from tpudl_torch.ml import KerasTransformer
    from tpudl_torch.udf import makeGraphUDF, unregister_udf

    config = keras_mlp_config()
    path = save_keras_file(os.path.join(directory, "mlp.keras"), config,
                           keras_weights(config, SEED))
    data = np.random.default_rng(SEED).normal(
        size=(KERAS_MLP_ROWS, KERAS_MLP_DIM)).astype(np.float32)
    frame = Frame({"x": data})
    makeGraphUDF(TFInputGraph.fromKeras(path), "mlp_udf",
                 batch_size=KERAS_MLP_BATCH)
    try:
        kt = KerasTransformer(inputCol="x", outputCol="y", modelFile=path,
                              batchSize=KERAS_MLP_BATCH)
        runs = {"sql(SELECT mlp_udf(x) AS y FROM t)": lambda: sql(
                    "SELECT mlp_udf(x) AS y FROM t", {"t": frame}),
                "KerasTransformer": lambda: kt.transform(frame)}
        for run in runs.values():
            run()                                          # warm
        rates, first, _ = interleaved_windows(
            runs, lambda run: np.stack(list(run()["y"])), KERAS_MLP_ROWS)
        for what, r in rates.items():
            print(f"  configs[4] MLP {what}, {KERAS_MLP_ROWS} rows at batch "
                  f"{KERAS_MLP_BATCH}, {len(r)} windows (the two in turn): "
                  f"median {median(r):.1f} rows/s (least {min(r):.1f}, most"
                  f" {max(r):.1f}); card {card}")
        a, b = first.values()
        same = a.shape == b.shape == (KERAS_MLP_ROWS, 10) and \
            np.array_equal(a, b)
        print(f"  makeGraphUDF through sql equals KerasTransformer bit for "
              f"bit: {same}")
        if not same:
            problems.append("makeGraphUDF differs from KerasTransformer")
    finally:
        unregister_udf("mlp_udf")


def text_udf_leg(card, problems):
    """register_text_udfs at phase 4's serving width: embed and classify
    over phase 4's texts, generate over its prompts; 12 flash forward
    launches a full-sequence batch, none backward; outputs equal bit for
    bit to the LM stages' transforms."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.frame import Frame, sql
    from tpudl_torch.ml import LMClassifier, LMFeaturizer, LMGenerator
    from tpudl_torch.text import ByteTokenizer
    from tpudl_torch.udf import register_text_udfs, unregister_udf
    from tpudl_torch.zoo.transformer import TinyCausalLM

    spec = TinyCausalLM(VOCAB, DIM, HEADS, LAYERS, MAX_LEN, device="meta")
    weights = spec.init(SEED)
    tok = ByteTokenizer()
    udfs = register_text_udfs(model=spec, weights=weights, tokenizer=tok,
                              classes=CLASSES, max_new=TEXT_UDF_MAX_NEW,
                              batch_size=BATCH)
    texts = make_texts(N_ROWS, SEED)
    docs = {"docs": Frame({"text": texts})}
    prompts = {"docs": Frame({"text": np.array(PROMPTS, dtype=object)})}
    try:
        for q, t in (("SELECT embed(text) AS v FROM docs LIMIT 2", docs),
                     ("SELECT classify(text) AS c FROM docs LIMIT 2", docs),
                     ("SELECT generate(text) AS g FROM docs LIMIT 1",
                      prompts)):
            sql(q, t)                                      # warm
        torch.cuda.synchronize()
        outs, launches = {}, {}
        for name, q, t, n in (
                ("embed", "SELECT embed(text) AS v FROM docs", docs, N_ROWS),
                ("classify", "SELECT classify(text) AS c FROM docs", docs,
                 N_ROWS),
                ("generate", "SELECT generate(text) AS g FROM docs",
                 prompts, len(PROMPTS))):
            reset_launch_counts()
            t0 = time.perf_counter()
            out = sql(q, t)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches[name] = dict(cuda_ops.launch_counts)
            outs[name] = list(out[out.columns[0]])
            print(f"  sql(\"{q}\"): {n} rows in {dt:.3f} s = {n / dt:.2f} "
                  f"rows/s; kernel launches {launches[name]}; card {card}",
                  flush=True)
        n_batches = -(-N_ROWS // BATCH)
        want_fwd = {"embed": LAYERS * n_batches,
                    "classify": LAYERS * n_batches, "generate": 0}
        for name, want in want_fwd.items():
            c = launches[name]
            if c["flash_attn_fwd"] != want or c["flash_attn_bwd_dq"] or \
                    c["flash_attn_bwd_dkv"]:
                problems.append(f"{name} UDF launched {c} (want {want} "
                                "forward, 0 backward)")
        print(f"  flash forward launches: embed {launches['embed']['flash_attn_fwd']}"
              f", classify {launches['classify']['flash_attn_fwd']} (want "
              f"{LAYERS} layers x {n_batches} batches = {LAYERS * n_batches}"
              f" each), generate {launches['generate']['flash_attn_fwd']} "
              "(KV-cache decode: 0); backward 0 in all")
        common = dict(inputCol="text", model=spec, weights=weights,
                      tokenizer=tok, batchSize=BATCH)
        frame = docs["docs"]
        ref = {
            "embed": [np.asarray(v) for v in LMFeaturizer(
                outputCol="o", **common).transform(frame)["o"]],
            "classify": list(LMClassifier(
                outputCol="o", classes=CLASSES, **common).transform(
                    frame)["o"]),
            "generate": list(LMGenerator(
                outputCol="o", maxNew=TEXT_UDF_MAX_NEW, **common).transform(
                    prompts["docs"])["o"])}
        same = {
            "embed": np.array_equal(np.stack(outs["embed"]),
                                    np.stack(ref["embed"])),
            "classify": outs["classify"] == ref["classify"],
            "generate": outs["generate"] == ref["generate"]}
        vecs = np.stack(outs["embed"])
        print(f"  the UDFs equal LMFeaturizer/LMClassifier/LMGenerator bit "
              f"for bit: {same}; embed {vecs.shape}, labels "
              f"{ {c: outs['classify'].count(c) for c in CLASSES} }")
        if not all(same.values()) or vecs.shape != (N_ROWS, DIM) or \
                not np.isfinite(vecs).all():
            problems.append(f"text UDFs against the stages: {same}")
    finally:
        for u in udfs:
            unregister_udf(u.name)
    return launches


def run_surface(card):
    """Phase 10: model selection and models as SQL UDFs at full width.
    Every check runs and prints; the phase fails at its end if any did
    not hold. Returns the kernel launches of the text UDFs' queries."""
    import shutil
    import tempfile

    from tpudl_torch.ingest.kerasfile import save_keras_file

    from tpudl_torch import cuda_ops

    t_phase = time.perf_counter()
    problems = []
    reset_launch_counts()
    directory = tempfile.mkdtemp(prefix="tpudl_surface_smoke_")
    try:
        config = keras_inception_config()
        path = save_keras_file(os.path.join(directory, "inception_tl.keras"),
                               config, keras_weights(config, SEED))
        uris, labels = keras_jpegs(directory, KERAS_JPEGS, SEED)
        t0 = time.perf_counter()
        surface_cv_leg(path, uris, labels, card, problems)
        print(f"  model selection leg: {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        gin, structs = tfimage_leg(directory, path, card, problems)
        print(f"  TFImageTransformer leg: {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        sql_image_leg(path, gin, structs, card, problems)
        sql_mlp_leg(directory, card, problems)
        print(f"  SQL UDF legs: {time.perf_counter() - t0:.1f} s",
              flush=True)
        counts = dict(cuda_ops.launch_counts)
        print(f"  attention kernel launches before the text UDFs: {counts} "
              "(want 0)")
        if any(counts.values()):
            problems.append(f"the image and MLP legs launched {counts}")
        t0 = time.perf_counter()
        launches = text_udf_leg(card, problems)
        print(f"  text UDF leg: {time.perf_counter() - t0:.1f} s",
              flush=True)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    print(f"  phase 10: {time.perf_counter() - t_phase:.1f} s; card {card}")
    if problems:
        fail("phase 10: " + "; ".join(problems))
    return {k: sum(c[k] for c in launches.values())
            for k in launches["embed"]}


# phase 11, TF graph ingestion at full width: the GraphDef, SavedModel and
# checkpoint routes of TFInputGraph over the committed TF fixtures
# (tests/fixtures/tf) and configs[2]'s InceptionV3 + head exported as a
# SavedModel, its variables written here from phase 9's seeded weights
GRAPH_FIXTURES = os.path.join("tests", "fixtures", "tf")
GRAPH_ROWS, GRAPH_BATCH, GRAPH_CPU_ROWS = 256, 64, 4
GRAPH_FUSE = 4
GRAPH_RTOL = 2e-5                  # of max |y|, as phase 6 holds images
GRAPH_F64_ATOL = 1e-12             # the float64 factory graph
GRAPH_TABLE_ROWS = 4096


def graph_fixture(*parts):
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(here, GRAPH_FIXTURES, *parts)


def graph_small_cases():
    """(name, builder, input) for every committed fixture and route: the
    float64 factory graph through all five file routes, the TF2 export
    and the two Keras exports through the signature and tensor-name
    routes."""
    from tpudl_torch.ingest import TFInputGraph as G

    rng = np.random.default_rng(SEED)
    x64 = rng.normal(size=(5, 3))
    x3 = rng.normal(size=(5, 3)).astype(np.float32)
    cnn = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    dw = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    sm = graph_fixture("factory_saved_model")
    ck = graph_fixture("factory_ckpt")
    with open(graph_fixture("factory.pb"), "rb") as f:
        pb = f.read()
    cases = [
        ("factory.pb fromGraphDef", lambda: G.fromGraphDef(pb, ["x"], ["z"]),
         x64),
        ("factory fromSavedModel", lambda: G.fromSavedModel(
            sm, "serve", ["x:0"], ["z:0"]), x64),
        ("factory fromSavedModelWithSignature",
         lambda: G.fromSavedModelWithSignature(sm, "serve", "my_sig"), x64),
        ("factory fromCheckpoint", lambda: G.fromCheckpoint(
            ck, ["x:0"], ["z:0"]), x64),
        ("factory fromCheckpointWithSignature",
         lambda: G.fromCheckpointWithSignature(ck, "my_sig"), x64)]
    for name, x in (("tf2_mlp", x3), ("keras_cnn", cnn),
                    ("keras_depthwise", dw)):
        d = graph_fixture(name)
        cases.append((f"{name} fromSavedModelWithSignature",
                      lambda d=d: G.fromSavedModelWithSignature(
                          d, "serve", "serving_default"), x))
        feed = "x:0" if name == "tf2_mlp" else "keras_tensor:0"
        cases.append((f"{name} fromSavedModel(['{feed}'], ['Identity:0'])",
                      lambda d=d, feed=feed: G.fromSavedModel(
                          d, "serve", [feed], ["Identity:0"]), x))
    return cases


def graph_small_leg(card, problems):
    """Every small fixture through every route, on the card against the
    CPU port (2e-5 of max |y|; the float64 graph 1e-12, and against
    3x + 4 in numpy)."""
    for name, build, x in graph_small_cases():
        gin = build()
        fn = gin.make_fn()
        got = fn(torch.from_numpy(x).cuda())
        torch.cuda.synchronize()
        got = got.cpu().numpy()
        want = fn(torch.from_numpy(x)).numpy()
        if x.dtype == np.float64:
            err = float(np.abs(got - want).max())
            ref = float(np.abs(got - (3 * x + 4)).max())
            ok = got.dtype == np.float64 and err <= GRAPH_F64_ATOL and \
                ref <= GRAPH_F64_ATOL
            detail = (f"{got.dtype}, {err:.1e} off the CPU, {ref:.1e} off "
                      f"3x + 4 (limit {GRAPH_F64_ATOL:g})")
        else:
            err = rel_err(got, want)
            ok = np.isfinite(got).all() and err <= GRAPH_RTOL
            detail = f"{err:.3e} of max |y| off the CPU (limit {GRAPH_RTOL:g})"
        print(f"  {name}: {gin.input_names} -> {gin.output_names}, out "
              f"{tuple(got.shape)}, {detail}")
        if not ok:
            problems.append(f"{name}: {detail}")


def graph_inception_files(directory):
    """configs[2]'s model with phase 9's seeded, BN-perturbed weights as a
    .keras file and as a SavedModel (the committed saved_model.pb, its
    variables/ written here with tf_bundle_writer)."""
    import gzip

    import tf_bundle_writer
    from tpudl_torch.ingest.kerasfile import save_keras_file

    config = keras_inception_config()
    weights = keras_perturbed(keras_weights(config, SEED))
    path = save_keras_file(os.path.join(directory, "inception_tl.keras"),
                           config, weights)
    sm_dir = os.path.join(directory, "inception_tl_saved_model")
    os.makedirs(sm_dir)
    with gzip.open(graph_fixture("inception_v3_tl", "saved_model.pb.gz"),
                   "rb") as f, open(os.path.join(sm_dir, "saved_model.pb"),
                                    "wb") as out:
        out.write(f.read())
    with gzip.open(graph_fixture("inception_v3_tl", "variables.json.gz"),
                   "rt") as f:
        keys = json.load(f)
    with gzip.open(graph_fixture("inception_v3_tl", "object_graph.bin.gz"),
                   "rb") as f:
        object_graph = f.read()
    t0 = time.perf_counter()
    tf_bundle_writer.write_saved_model_variables(sm_dir, keys, weights,
                                                 object_graph)
    print(f"  wrote the SavedModel's variables/ ({len(keys)} keys, "
          f"{sum(np.asarray(weights[p]).nbytes for p in keys.values()) / 1e6:.1f}"
          f" MB) in {time.perf_counter() - t0:.2f} s", flush=True)
    return path, sm_dir


def graph_ingest_time(sm_dir, card):
    """The time to ingest: parsing saved_model.pb, reading every bundle
    key the signature reaches with its CRC-32C check, and freezing."""
    from tpudl_torch.ingest import TFInputGraph
    from tpudl_torch.ingest import protowire as pw
    from tpudl_torch.ingest.tensor_bundle import BundleReader

    t0 = time.perf_counter()
    with open(os.path.join(sm_dir, "saved_model.pb"), "rb") as f:
        pw.parse("SavedModel", f.read())
    t_parse = time.perf_counter() - t0
    reader = BundleReader(os.path.join(sm_dir, "variables", "variables"))
    keys = [k for k in reader.keys() if k.startswith("variables/")]
    t0 = time.perf_counter()
    nbytes = sum(len(reader.raw(k)) for k in keys)
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    gin = TFInputGraph.fromSavedModelWithSignature(sm_dir, "serve",
                                                   "serving_default")
    t_route = time.perf_counter() - t0
    print(f"  ingest: saved_model.pb parsed in {t_parse:.3f} s; {len(keys)} "
          f"bundle keys, {nbytes / 1e6:.1f} MB read with the CRC-32C check in"
          f" {t_read:.3f} s ({nbytes / 1e6 / t_read:.0f} MB/s); "
          f"fromSavedModelWithSignature (parse, restore keys, read what the "
          f"signature reaches, freeze) {t_route:.3f} s; card {card}",
          flush=True)
    return gin


def run_graph_ingest(card):
    """Phase 11: TF graph ingestion at full width. Every check runs and
    prints; the phase fails at its end if any did not hold."""
    import shutil
    import tempfile

    from tpudl_torch import cuda_ops
    from tpudl_torch.device import full_f32
    from tpudl_torch.frame import Frame, sql
    from tpudl_torch.image import imageStructToArray
    from tpudl_torch.ingest import GraphFunction, TFInputGraph
    from tpudl_torch.ml import TFImageTransformer, TFTransformer
    from tpudl_torch.obs import metrics
    from tpudl_torch.udf import makeGraphUDF, unregister_udf

    t_phase = time.perf_counter()
    problems = []
    reset_launch_counts()
    t0 = time.perf_counter()
    graph_small_leg(card, problems)
    print(f"  small fixtures: {time.perf_counter() - t0:.1f} s", flush=True)
    directory = tempfile.mkdtemp(prefix="tpudl_graph_smoke_")
    try:
        path, sm_dir = graph_inception_files(directory)
        gin = graph_ingest_time(sm_dir, card)
        print(f"  InceptionV3 + head SavedModel: "
              f"{gin.input_tensor_name_from_signature} -> "
              f"{gin.output_tensor_name_from_signature}", flush=True)
        kgin = TFInputGraph.fromKeras(path)
        structs = image_structs(GRAPH_ROWS, (KERAS_SIDE, KERAS_SIDE, 3), SEED)
        x = np.stack([imageStructToArray(s)[..., ::-1] for s in
                      structs[:GRAPH_CPU_ROWS]]).astype(np.float32)
        sm_fn, k_fn = gin.make_fn(), kgin.make_fn()
        # in full f32, as the stages run both graphs (phase 6 leaves
        # cuDNN's TF32 at PyTorch's default)
        with torch.inference_mode(), full_f32():
            got = sm_fn(torch.from_numpy(x).cuda()).cpu().numpy()
            keras_y = k_fn(torch.from_numpy(x).cuda()).cpu().numpy()
            cpu_y = sm_fn(torch.from_numpy(x)).numpy()
        for what, want in (("the .keras route on the card", keras_y),
                           ("the same route on the CPU", cpu_y)):
            err = rel_err(got, want)
            print(f"  SavedModel route on the card, {GRAPH_CPU_ROWS} rows "
                  f"{KERAS_SIDE}x{KERAS_SIDE}, against {what}: {err:.3e} of "
                  f"max |y| (limit {GRAPH_RTOL:g}); card {card}")
            if not (got.shape == (GRAPH_CPU_ROWS, 2) and err <= GRAPH_RTOL):
                problems.append(f"SavedModel route against {what}: {err:.3e}")

        frame = Frame({"image": structs})
        stages = {
            "TFImageTransformer(SavedModel graph)": TFImageTransformer(
                inputCol="image", outputCol="out", graph=gin,
                batchSize=GRAPH_BATCH),
            "TFImageTransformer(.keras graph)": TFImageTransformer(
                inputCol="image", outputCol="out", graph=kgin,
                batchSize=GRAPH_BATCH)}
        for st in stages.values():
            st.transform(Frame({"image": structs[:GRAPH_BATCH]}))   # warm
        rates, first, _ = interleaved_windows(
            stages, lambda st: np.stack(list(st.transform(frame)["out"])),
            GRAPH_ROWS)
        for what, r in rates.items():
            print(f"  {what}, f32, {GRAPH_ROWS} images {KERAS_SIDE}x"
                  f"{KERAS_SIDE} at batch {GRAPH_BATCH}, {len(r)} windows "
                  f"(the two in turn): median {median(r):.1f} images/s "
                  f"(least {min(r):.1f}, most {max(r):.1f}); card {card}")
        serial = first["TFImageTransformer(SavedModel graph)"]
        fused_stage = TFImageTransformer(
            inputCol="image", outputCol="out", graph=gin,
            batchSize=GRAPH_BATCH, fuseSteps=GRAPH_FUSE)
        fused_stage.transform(frame)                               # capture
        fused = np.stack(list(fused_stage.transform(frame)["out"]))
        same = np.array_equal(fused, serial)
        print(f"  fuseSteps={GRAPH_FUSE} arm, {GRAPH_ROWS} rows, equal bit "
              f"for bit to the first arm: {same}")
        if not same:
            problems.append("fused SavedModel arm differs from the serial")

        labels = np.arange(GRAPH_ROWS) % 2
        rgb = np.empty(GRAPH_ROWS, dtype=object)
        rgb[:] = [np.ascontiguousarray(imageStructToArray(s)[..., ::-1],
                                       dtype=np.float32) for s in structs]
        table = Frame({"x": rgb, "label": labels, "image": structs})
        makeGraphUDF(gin, "inception_sm_udf", batch_size=GRAPH_BATCH,
                     feeds_to_fields_map={gin.input_names[0]: "x"})
        try:
            rows = metrics.counter("udf.inception_sm_udf.rows")
            before = rows.value
            q = (f"SELECT inception_sm_udf(x) AS preds FROM t WHERE label = "
                 f"1 LIMIT {SQL_LIMIT}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            preds = np.stack(list(sql(q, {"t": table})["preds"]))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            n = rows.value - before
            chosen = table.filter_rows(labels == 1).limit(SQL_LIMIT)
            want = np.stack(list(stages[
                "TFImageTransformer(SavedModel graph)"].transform(
                    chosen)["out"]))
            same = preds.shape == want.shape and np.array_equal(preds, want)
            print(f"  makeGraphUDF over the SavedModel graph: sql(\"{q}\") "
                  f"over {GRAPH_ROWS} rows: {dt:.3f} s, {n:.0f} rows through"
                  f" the UDF (want {SQL_LIMIT}); equal bit for bit to "
                  f"TFImageTransformer on the same rows: {same}; card {card}")
            if n != SQL_LIMIT or not same:
                problems.append(f"SavedModel UDF through sql: {n} rows, "
                                f"equal {same}")
        finally:
            unregister_udf("inception_sm_udf")
    finally:
        shutil.rmtree(directory, ignore_errors=True)

    ck = TFInputGraph.fromCheckpointWithSignature(
        graph_fixture("factory_ckpt"), "my_sig")
    xs = np.random.default_rng(SEED).normal(size=(GRAPH_TABLE_ROWS, 3))
    t = TFTransformer(tfInputGraph=ck, inputMapping={"v": "input_sig"},
                      outputMapping={"output_sig": "z"}, batchSize=1024)
    t.transform(Frame({"v": xs[:1024]}))                           # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z = np.stack(list(t.transform(Frame({"v": xs}))["z"]))
    dt = time.perf_counter() - t0
    err = float(np.abs(z - (3 * xs + 4)).max())
    print(f"  TFTransformer over the float64 checkpoint graph (signature "
          f"names), {GRAPH_TABLE_ROWS} rows: {GRAPH_TABLE_ROWS / dt:.0f} "
          f"rows/s, {z.dtype}, {err:.1e} off 3x + 4 (limit "
          f"{GRAPH_F64_ATOL:g}); card {card}")
    if z.dtype != np.float64 or not err <= GRAPH_F64_ATOL:
        problems.append(f"TFTransformer float64: {z.dtype}, {err:.1e}")
    chain = GraphFunction.fromList([
        ("ckpt", GraphFunction.fromTFInputGraph(ck)),
        ("double", GraphFunction(lambda v: v * 2, ["z"], ["y"]))])
    makeGraphUDF(chain, "chain_udf", feeds_to_fields_map={"ckpt/x": "v"})
    try:
        y = np.stack(list(sql("SELECT chain_udf(v) AS y FROM t", {
            "t": Frame({"v": xs[:256]})})["y"]))
    finally:
        unregister_udf("chain_udf")
    err = float(np.abs(y - 2 * (3 * xs[:256] + 4)).max())
    print(f"  GraphFunction.fromList([checkpoint graph, v * 2]) as a UDF "
          f"through sql, 256 rows: {err:.1e} off 2(3x + 4) (limit "
          f"{GRAPH_F64_ATOL:g})")
    if not err <= GRAPH_F64_ATOL:
        problems.append(f"fromList UDF {err:.1e}")
    counts = dict(cuda_ops.launch_counts)
    print(f"  attention kernel launches in phase 11: {counts} (want 0)")
    if any(counts.values()):
        problems.append(f"phase 11 launched {counts}")
    print(f"  phase 11: {time.perf_counter() - t_phase:.1f} s; card {card}")
    if problems:
        fail("phase 11: " + "; ".join(problems))
    return counts


def main(argv) -> int:
    card = card_line()
    print(f"card: {card}", flush=True)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this script measures "
             "the port on an NVIDIA GPU and has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}) on "
          f"{torch.cuda.get_device_name(0)}; TF32 off for matmul and cuDNN "
          "(f32 products run in full f32)", flush=True)
    if argv == ["--image-only"]:
        # phase 6 alone, in a process that has run no profiler session
        print(f"phase 6 alone: image slice at full width on {card}",
              flush=True)
        run_image_slice(card)
        print(f"card: {card}")
        print("image-only run: every check passed")
        return 0
    if argv == ["--executor-only"]:
        print(f"phase 7 alone: the executor at full width on {card}",
              flush=True)
        run_executor(card)
        print(f"card: {card}")
        print(f"executor-only run: every check passed in "
              f"{time.perf_counter() - T_START:.1f} s")
        return 0
    if argv == ["--train-only"]:
        print(f"phase 8 alone: ResNet50 training through HorovodRunner on "
              f"{card}", flush=True)
        run_resnet_training(card)
        print(f"card: {card}")
        print(f"train-only run: every check passed in "
              f"{time.perf_counter() - T_START:.1f} s")
        return 0
    if argv == ["--keras-only"]:
        print(f"phase 9 alone: the Keras surface at full width on {card}",
              flush=True)
        run_keras_surface(card)
        print(f"card: {card}")
        print(f"keras-only run: every check passed in "
              f"{time.perf_counter() - T_START:.1f} s")
        return 0
    if argv == ["--surface-only"]:
        print(f"phase 10 alone: model selection and SQL UDFs at full width "
              f"on {card}", flush=True)
        run_surface(card)
        print(f"card: {card}")
        print(f"surface-only run: every check passed in "
              f"{time.perf_counter() - T_START:.1f} s")
        return 0
    if argv == ["--graph-only"]:
        print(f"phase 11 alone: TF graph ingestion at full width on {card}",
              flush=True)
        run_graph_ingest(card)
        print(f"card: {card}")
        print(f"graph-only run: every check passed in "
              f"{time.perf_counter() - T_START:.1f} s")
        return 0
    if len(argv) == 2 and argv[0] == "--ranks":
        print(f"data-parallel ResNet50 training over {argv[1]} ranks on "
              f"{card}", flush=True)
        run_data_parallel(card, int(argv[1]))
        print(f"card: {card}")
        print(f"ranks run: every check passed in "
              f"{time.perf_counter() - T_START:.1f} s")
        return 0
    if argv == ["--pool-study"]:
        print(f"the prepare pool's study on {card}", flush=True)
        pool_study(card)
        print(f"card: {card}")
        print(f"pool study: every check passed in "
              f"{time.perf_counter() - T_START:.1f} s")
        return 0
    if argv:
        fail(f"unknown arguments {argv}; the options are --image-only, "
             "--executor-only, --train-only, --keras-only, --surface-only, "
             "--graph-only, --ranks N and --pool-study")

    from tpudl_torch import _build

    print("phase 2: build", flush=True)
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"  built {sorted(logs) or 'nothing (cached)'} from "
          f"{_build.CSRC} in {time.perf_counter() - t0:.1f} s")
    check_ptxas(logs)

    print("phase 3: kernels vs their plain versions", flush=True)
    slice_err = check_flash()
    bwd_err = check_flash_bwd()

    print(f"phase 4: serving slice at full width on {card}", flush=True)
    launches = run_slice()

    print(f"phase 4b: training slice at full width on {card}", flush=True)
    train_counts = run_training()

    print("phase 5: kernel timing at the serving shape "
          f"{list(SLICE_SHAPE)} causal", flush=True)
    kernels = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        t = time_flash(dtype)
        b = flash_bound(SLICE_SHAPE, SLICE_SHAPE[1], name)
        print(f"  {name}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f}"
              f" ms, scaled_dot_product_attention {t['library_ms']:.4f} ms;"
              f" {bound_text(b, t['ms'])}; card {card}")
        if dtype == torch.float32:   # the dtype the serving path runs
            fwd_entry = {
                "name": "flash_attn_fwd", "route": "cuda",
                "source": "tpudl_torch/csrc/flash_attn_fwd.cu",
                "replaces": "tpudl/pallas_ops.py:77",
                "launches": launches, "max_abs_err": slice_err,
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                **bound_keys(b, t["ms"]),
                "library_ms": t["library_ms"],
                "shape": list(SLICE_SHAPE), "dtype": name,
                "launches_by_path": {
                    "serving": launches,
                    "training": train_counts["flash_attn_fwd"]}}
            kernels.append(fwd_entry)
    print(f"phase 5: backward kernel timing at the training shape "
          f"{list(TRAIN_SHAPE)} causal", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        t = time_bwd(dtype)
        bounds = bwd_bounds(TRAIN_SHAPE, name)
        fwd_bound = flash_bound(TRAIN_SHAPE, TRAIN_SHAPE[1], name)
        print(f"  {name}: forward kernel {t['fwd_ms']:.4f} ms "
              f"({bound_text(fwd_bound, t['fwd_ms'])}), "
              f"scaled_dot_product_attention forward "
              f"{t['library_fwd_ms']:.4f} ms; backward: dq "
              f"{t['dq_ms']:.4f} ms, dk/dv {t['dkv_ms']:.4f} ms (pair "
              f"{t['dq_ms'] + t['dkv_ms']:.4f} ms), whole backward "
              f"{t['bwd_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms,"
              f" scaled_dot_product_attention backward "
              f"{t['library_bwd_ms']:.4f} ms (forward+backward "
              f"{t['library_fwd_bwd_ms']:.4f} - forward "
              f"{t['library_fwd_ms']:.4f}); card {card}")
        for kernel in ("dq", "dkv"):
            print(f"    {kernel}: {bound_text(bounds[kernel], t[kernel + '_ms'])}")
        if dtype != torch.float32:   # the training path runs f32
            continue
        # the forward at the training shape, beside SDPA's forward there
        fwd_entry["training"] = {
            "shape": list(TRAIN_SHAPE), "ms": t["fwd_ms"],
            **bound_keys(fwd_bound, t["fwd_ms"]),
            "library_ms": t["library_fwd_ms"]}
        for kernel, line in (("dq", 129), ("dkv", 164)):
            kernels.append({
                "name": f"flash_attn_bwd_{kernel}", "route": "cuda",
                "source": "tpudl_torch/csrc/flash_attn_bwd.cu",
                "replaces": f"tpudl/pallas_ops.py:{line}",
                "launches": train_counts[f"flash_attn_bwd_{kernel}"],
                "max_abs_err": bwd_err[kernel],
                "ms": t[f"{kernel}_ms"],
                # the plain and library versions compute dq, dk and dv
                # together: the whole backward is their yardstick
                "plain_ms": t["plain_ms"],
                **bound_keys(bounds[kernel], t[f"{kernel}_ms"]),
                "library_ms": t["library_bwd_ms"],
                "shape": list(TRAIN_SHAPE), "dtype": name})
    print(f"phase 6: image slice at full width on {card}", flush=True)
    run_image_slice(card)
    print(f"phase 7: the executor at full width on {card}", flush=True)
    fwd_entry["launches_by_path"]["executor"] = run_executor(card)
    print(f"phase 8: ResNet50 training through HorovodRunner on {card}",
          flush=True)
    resnet_counts = run_resnet_training(card)
    print(f"phase 9: the Keras surface at full width on {card}", flush=True)
    keras_counts = run_keras_surface(card)
    print(f"phase 10: model selection and SQL UDFs at full width on {card}",
          flush=True)
    surface_counts = run_surface(card)
    print(f"phase 11: TF graph ingestion at full width on {card}",
          flush=True)
    graph_counts = run_graph_ingest(card)
    for entry in kernels:
        entry.setdefault("launches_by_path", {
            "training": train_counts[entry["name"]]})
        entry["launches_by_path"]["resnet50_training"] = \
            resnet_counts[entry["name"]]
        entry["launches_by_path"]["keras_surface"] = \
            keras_counts[entry["name"]]
        entry["launches_by_path"]["sql_text_udfs"] = \
            surface_counts[entry["name"]]
        entry["launches_by_path"]["graph_ingest"] = \
            graph_counts[entry["name"]]
    print(f"card: {card}")
    print(f"chip_smoke.py: every check passed in "
          f"{time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
