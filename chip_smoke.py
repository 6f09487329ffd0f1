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
   and spread of 2 windows each), achieved TFLOP/s against the bounds,
   and the per-batch function's rate alone; hold 4 rows (and 2 of the
   480×640 batch) against the same stage on the CPU, bf16 against f32,
   and a profile split of one batch in each dtype. Then the other nine
   named models, each at its own input size from seeded random weights:
   ResNet50 and Xception (BASELINE.json configs[1]) with the featurizer
   and the predictor over 512 rows in f32 and bf16, and VGG16, VGG19,
   MobileNetV2, DenseNet121, ResNet101, ResNet152 and EfficientNetB0 with
   the featurizer over 256 rows in f32 and bf16 and one predictor call;
   each prints its parameter count, counted work, rates (median and
   spread of 2 windows) and the time of its leg, holds bf16 against f32,
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
   batches of 64: images/s (median and spread of 2 windows), the
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
   100 at ``batchSize=8192`` (rows/s, median and spread of 2 windows; 64
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
   in turn (images/s, 256 structs, batch 64, f32, 2 windows), its
   ``fuseSteps=4`` arm bit for bit, ``makeGraphUDF`` over it through
   ``sql`` (WHERE, LIMIT 64) bit for bit against ``TFImageTransformer``;
   ``TFTransformer`` over the float64 checkpoint graph by signature
   names, a ``GraphFunction.fromList`` UDF; no flash launch.

12. Drive the Keras files the port refused before, at full width:
   configs[2]'s InceptionV3 + head from a Keras 2-era ``.h5`` (tf_keras's
   committed ``model_config``, written here by ``keras2_h5_writer`` with
   phase 9's seeded, BN-perturbed weights): the transformer over it equal
   bit for bit to the ``.keras`` of the same weights, the
   ``KerasImageFileEstimator`` fit over each file (96 JPEGs, batch 16,
   adam; cold, warm, steps/s, the train loop, the trained ``.keras`` read
   back bit for bit), and the ``.h5``'s first-step gradients against
   float64 on the card (1e-2 of the largest); keras-io's text classifier
   from a Keras 2 ``.h5`` through ``KerasTransformer`` (65,536 rows of 500
   int64 ids at batch 8192: rows/s, 64 rows against the CPU, the dtype
   that reaches the graph); Keras 3's MobileNetV3Large at 224x224 through
   ``KerasImageFileTransformer`` (256 JPEGs: images/s; 2 rows with
   perturbed BN against the CPU); every committed small model of
   ``tests/fixtures/keras2`` card vs CPU (2e-5 of max |y|; the
   bfloat16-policy model 1e-2); no flash launch; the phase's seconds.

13. Drive the data layer (``tpudl_torch.data``) at full width: the codecs
   on the card (a 512×299×299×3 uint8 batch through ``U8Codec`` at scale
   1, 1/255 and 1/255 with an offset, ``BF16Codec`` over the special
   values, ``TokenCodec`` u16 and i32: each prologue bit for bit its
   ``decode_array``, wire bytes against dense f32); configs[2]'s
   InceptionV3 + head (phase 9's seeded, BN-perturbed weights) through
   ``KerasImageFileTransformer`` over 512 JPEGs, batch 64, in four arms
   (the float32 loader; the uint8 loader and its u8 codec; that with
   ``cacheDir``, cold then warm; that with ``deviceCache``), images/s
   over 2 windows, the decodes, shard hits, bytes prepared and h2d
   seconds of each, the card's idle share, every arm bit for bit the
   first and 2 rows against the CPU; ``budget_bytes()`` and arm (d) under
   a 64 MB budget (evictions, bit for bit); configs[2]'s fit with the
   uint8 loader, ``cacheDir`` and ``deviceCache`` (decodes 96 then 0,
   losses bit for bit the fit without them under ``cudnn.deterministic``,
   the pin released, first-step gradients against float64); phase 4b's
   model trained 2 epochs of 5 steps from ``lm_dataset`` (epoch 2
   tokenizes and ships nothing, 12 launches of each kernel a step, losses
   bit for bit the direct int32 feed); phase 4's ``LMFeaturizer`` with
   ``wireCodec="tokens"`` and ``cacheDir``, cold then warm (no
   tokenization warm, 12 launches a batch, features bit for bit); the
   phase's seconds.

14. Drive the data-parallel mesh (``tpudl_torch.mesh``) at full width: a
   one-card mesh (``build_mesh(devices=["cuda:0"])``), the one-card
   rehearsal of two entries (``["cuda:0", "cuda:0"]``: two replicas, each
   on half of every batch) and, where more than one card is visible, the
   mesh of every card. ``DeepImageFeaturizer("InceptionV3")`` over 512
   structs at 299x299, f32 and bf16, each mesh and its ``fuseSteps=4`` arm
   beside the stage without a mesh (the one-card mesh bit for bit, the
   others within 2e-5 of max |y| in f32 and 1e-2 in bf16), images/s of every arm over 2 windows
   with the arms in turn; ``LMFeaturizer`` at phase 4's width over 69
   texts (the one-card mesh bit for bit, the others within 1e-4 of max
   |y|; 12 forward launches a batch on every entry; the report's mesh and
   pad rows on the ragged tail; the fused arm); configs[2]'s
   ``KerasImageFileEstimator.fit`` over each mesh of two or more entries
   against the fit on one card (losses within 2e-5) and its first-step
   gradients against float64 (1e-2 of the largest), ``fitMultiple`` with
   2 trials over 2 entries; ``Dataset(mesh=)`` with its second epoch
   resident and 0 bytes shipped; with several cards, the forward kernel
   against its plain version on every card; the phase's seconds.

15. Drive serving (``tpudl_torch.serve``) at phase 4's width from seeded
   weights: ``ModelRegistry.add_model`` with 8 slots of 1024 cache
   positions, which captures the decode-step, prefill and insert CUDA
   graphs (``warm_signatures``, ``warm_s``, the slot cache's bytes); 8
   greedy requests of prompts 5–300 tokens × 32 new tokens through the
   slots, each stream equal to the serial batch-1 ``generate`` on the
   card (2 also to the CPU port's), and one step's graph replay against
   the same step run eagerly on the same state (1e-4 of max |logit|); 24
   requests of 6 prompt lengths through the server (3 cycles of insert,
   complete and reuse), an eviction mid-decode whose neighbours and
   successor stay equal to serial ``generate``, a sampled engine
   (temperature 0.8) against ``generate(generator=)``, and no graph
   captured after registration; ``run_closed_loop`` (64 requests, 8
   clients, prompts 16–256 tokens, 32 new tokens) against the threaded
   server: qps, p50/p99 ms, TTFT percentiles, tokens/s and slot occupancy
   beside the serial eager ``generate`` over every 4th of the same
   prompts, the time of one 256-token insert, one step's
   replay against the eager step, the card's idle share over 10 steady
   steps and the eager step's kernel time by op group, 0 flash launches;
   a typed ``queue_full`` and ``slots_full`` and a deadline shed
   mid-decode; ``RungBatcher`` over the LM embed function with payloads
   of 3, 5 and 11 rows of 256 tokens (one dispatch of 24 rows, 12 flash
   forward launches, within 1e-4 of max |y| of ``LMFeaturizer``); the
   phase's seconds.
16. Drive LM parallelism on local meshes — 4 entries of one card always,
   and every visible card where there are two or more: the flash-kernel
   ring (``ring_attention(use_pallas=True)``) at ``[1, 32768, 16, 64]``
   causal in f32 and bf16 against one flash call on the whole sequence
   (forward, and q/k/v gradients under autograd), 10 launches of each
   kernel a ring call over 4 entries, each arm's ms beside the one
   call's, and the plain ring at 8192 tokens; ``TinyCausalLM(32000,
   1024, 16, 12, max_len=16384)`` over the ring on one 16384-token row
   against ``apply`` without a mesh (120 forward launches, each card's
   idle share); README's long-context recipe ``Trainer(lm.loss_fn(mesh=,
   use_pallas=True), adamw(3e-4), mesh=)`` for ``TinyCausalLM(50257, 512,
   8, 12)`` on one 8192-token row (first loss against the one-card
   loss, first-step gradients against float64 at 1024 tokens, 120
   launches of each kernel a step, steps/s and tokens/s); tensor
   parallelism on a ``(1, N)`` mesh (2 entries of one card, or every
   card): ``apply(tp=True)`` logits, greedy ``generate(tp=True)``, 8
   ``SlotDecoder(tp=True)`` streams against serial ``generate``,
   ``LMFeaturizer(mesh=, tp=True)``, each card's 1/N of the split
   leaves, two ``param_shardings`` sgd steps; ``experts=8`` under
   ``tp=True`` against the unsplit model (routing equal, the share of
   tokens dropped, two sgd steps); ``apply_pipelined`` over 4 stages with
   8 microbatches against ``apply``, and two sgd steps through it; the
   phase's seconds.
17. Drive the compile subsystem (``tpudl_torch.compile``: the program
   store over CUDA graphs, armed with ``TPUDL_COMPILE_AOT``) at phase 4's
   width: ``LMFeaturizer`` over 128 texts armed against unarmed (the
   first armed run misses on its first batch only, 12 flash forward
   launches a batch in both, graph replays counted, features bit for bit
   or within 2e-5 of max |y|, rows/s over 2 windows with the arms in
   turn); InceptionV3 bf16 ``DeepImageFeaturizer`` unfused over 512
   structs armed against unarmed (``warmup(299, 299)`` then ``transform``
   misses nothing, features within 1e-2 of max |y|, images/s over 3
   windows and each arm's card idle share); greedy ``generate`` through
   one graph for 4 prompts of one pow2 rung (tokens equal to eager on the
   card and 2 to the CPU port's, one graph, new tokens/s of graph and
   eager, the card memory the capture reserved); ``precompile_serve``
   through the registry then 8 greedy slot streams equal to serial
   ``generate`` with no capture after registration, and ``RungBatcher``
   over the embed function through the store (12 forward launches a
   replay); cold start in child processes (``--compile-child``), two an
   arm, timed from process start and from ``warm_start`` returning to
   the first result — arm A on an empty store, arm B on A's manifest
   (its first dispatch a hit) — for ``LMFeaturizer`` and for
   ``generate``, and one child on an empty kernel directory
   (``TPUDL_COMPILE_CACHE_DIR``) that prints the nvcc build seconds; the
   phase's seconds.
18. The model axis over a process group (``tpudl_torch.collectives``):
   NCCL ranks spawned by ``HorovodRunner`` under ``TPUDL_MESH_MODEL``,
   one card each, over every visible card. First the three kernels
   against their plain versions at the per-rank shapes of a 2- and a
   4-way split (``[4, 1024, 8, 64]``, ``[4, 1024, 4, 64]``) and at a ring
   rank's hop offsets. With N >= 2 cards: a ``(1, N)`` grid (TP on
   ``TinyCausalLM(32000, 1024, 16, 12)``: logits within 1e-4 of max
   |logit| of the unsplit model, 12 forward launches a rank, two
   ``param_shardings`` sgd steps' losses within 2e-5 of one card's, each
   rank's 1/N of the split leaves); ``experts=8`` on an ``(N/2, 2)`` grid
   (each rank's block and routing against the unsplit model, two sgd
   steps); an ``(N, 1)`` grid (the ring on README's long-context model at
   8192 tokens: the first loss within 2e-5 of one card's, first-step
   gradients within 1e-2 of float64's largest at 1024 tokens, ``i + 1``
   launches of each kernel a block on rank ``i``); a save, a gang restart
   (every rank failing once) and a resume equal to the uninterrupted run
   (losses and a digest of the params). Each leg prints ms or steps/s,
   each rank's idle share of a step and the bytes each collective moves a
   step, reckoned from the shapes, beside phase 16's local-mesh figures of
   the same call. With one card (NCCL refuses two ranks on one card) the
   legs run on a ``(1, 1)`` grid, a world of one, against the run without
   a mesh (logits within 1e-5 of max |logit|, losses within 2e-5). The
   phase's seconds.
19. The job runtime, the fault harness and the supervisor (``tpudl_torch.jobs``,
   ``tpudl_torch.testing.faults``, ``tpudl_torch.frame.supervisor``,
   ``tpudl_torch.obs.flight``) at full width, under
   ``cudnn.deterministic`` as phase 8's restart: phase 4b's
   ``TinyCausalLM(50257, 512, 8, 12)`` (adamw, 8 x 1025 tokens, 12 steps,
   a checkpoint every 4) as a ``JobSpec(kind="fit")`` through
   ``JobRuntime.run_fit(exit_on_preempt=True)`` in a child process
   (``--jobs-child``) that ``kill_at_step(7)`` SIGTERMs through
   ``TPUDL_FAULT_PLAN`` (exit 75, a ``preempted`` manifest with the step
   cursor, a flight dump in the workdir), then a relaunch of the same
   spec that resumes and finishes (the steps reworked, at most 4; its
   final ``state_dict`` bit for bit an uninterrupted run in this process;
   12 launches of each kernel a step in both attempts), each child's wall
   time, and a changed spec refused; phase 4's ``LMFeaturizer`` over 64
   texts with ``fuseSteps=4`` and ``dispatchDepth=4`` under
   ``TPUDL_FRAME_DEGRADE=1``: an injected OOM at ``frame.dispatch``
   (``evict_hbm``, 256 MB of resident device-cache entries evicted),
   three dispatch faults (depth 4 -> 2 -> 1, then ``fuseSteps`` -> 1), a
   real allocator OOM (``fn``'s first call asks for more than
   ``mem_get_info`` reports free) and ``TPUDL_FRAME_DEGRADE_MAX_RUNGS=1``
   (the typed error and a dump), each recovered run bit for bit the
   healthy run, 12 flash launches a batch, and each arm's seconds beside
   the healthy arm's; phase 15's engine (8 slots x 1024, three graphs at
   registration) behind a supervised ``Server`` with a fault at
   ``serve.dispatch`` on tick 5: 8 greedy streams equal to serial
   ``generate``, no capture after registration. The phase's seconds.
20. The rest of observability (``tpudl_torch.obs``) at phase 4's width,
   every executor run before it under ``TPUDL_FRAME_AUTOTUNE=0``:
   ``LMFeaturizer`` over 64 texts, per batch and fused, under
   ``obs.profile`` with the watchdog, a status directory and
   ``obs.scope(tenant=)`` armed (the flash forward kernel on Kineto's
   device lanes as often as the launch counter, 12 a batch; the
   capture's marker record; features bit for bit; the status file
   through ``tools/validate_status.py``; the ledger reconciled); one
   phase-4b training step under ``obs.profile`` (dq and dk/dv 12 each);
   a stall in a child (``--obs-stall-child``) that ``python -m
   tpudl_torch.obs doctor`` classifies ``infeed_stall``;
   ``map_batches(autotune=)`` on InceptionV3 bf16 unfused and on the LM
   (the seeds, rates over 3 windows an arm, bit for bit); phase 15's
   engine behind a ``Server`` under ``run_closed_loop(tenant=)`` with two
   tenants (the SLO gauges, the ledger, ``obs top --once``); the armed
   plane against unarmed on the LM and fused InceptionV3 bf16. The
   phase's seconds.
21. The analyzers, the lock sanitizer, the capture-storm sentinel and
   the debug hooks at phase 4's width: ``python -m tpudl_torch.analysis
   tpudl_torch`` exits 0; four children started together
   (``--analysis-child KIND DIR``): under ``TPUDL_TSAN=1
   TPUDL_TRACECK=1`` phase 4's ``LMFeaturizer`` over 64 texts eager and
   with ``fuseSteps=4`` through the program store (12 flash launches a
   batch, features bit for bit this process's unarmed run), phase 15's
   engine behind a supervised ``Server`` (8 greedy streams equal to
   serial ``generate``) and one phase-4b step under ``debug_nans`` (12 of
   each backward kernel, the loss bit for bit the plain step's), its
   report with no finding and no storm, the hold times and the captures
   per identity printed; a fresh closure through the store 5 times under
   ``TPUDL_TRACECK_STORM=3`` (one storm, which ``python -m
   tpudl_torch.obs doctor`` reads ``recompile_storm``); two threads
   taking two named locks in opposite orders (``DeadlockError``, a
   report naming both); ``checkify_fn`` around phase 4's embedding
   function captured through the store (a clean replay bit for bit, a
   NaN written into the embedding table and an out-of-range token id
   each flagged after its replay, no device-side assert). The phase's
   seconds.

Every device-time reading (the idle shares, the profile splits, the
merged timeline) goes through ``tpudl_torch.obs.trace.capture``: marker
kernels fence the block and absorb what the profiler drops at a
capture's head; a truncated capture is taken again once, then fails.

The last line is ``{"ok": true, "device": {"platform": "gpu", ...}}``.

``python3 chip_smoke.py --image-only`` runs phase 1 and then phase 6
alone, every model's leg: the image slice's rates in a process that has
run no profiler session before them (phases 4 and 4b profile a batch and
a step). ``python3 chip_smoke.py --executor-only`` runs phase 1 and then
phase 7 alone. ``python3 chip_smoke.py --train-only`` runs phase 1 and then phase 8
alone. ``python3 chip_smoke.py --keras-only`` runs phase 1 and then phase 9
alone. ``python3 chip_smoke.py --surface-only`` runs phase 1 and then
phase 10 alone. ``python3 chip_smoke.py --graph-only`` runs phase 1 and then phase 11
alone. ``python3 chip_smoke.py --keras2-only`` runs phase 1 and then
phase 12 alone, ``--data-only`` phase 1 and then phase 13, and
``--mesh-only`` phase 1 and then phase 14, ``--serve-only`` phase 1 and
then phase 15, ``--parallel-only`` phase 1 and then phase 16,
``--compile-only`` phase 1 and then phase 17, ``--group-only`` phase 1,
phase 16 (whose local-mesh figures phase 18 prints beside its own) and
then phase 18, over every visible card, ``--jobs-only`` phase 1 and
then phase 19, ``--obs-only`` phase 1 and then phase 20, and
``--analysis-only`` phase 1 and then phase 21.
``python3 chip_smoke.py --profile-study`` profiles phase 20's
``LMFeaturizer`` in a fresh process and again after each of several
kinds of earlier profiler sessions, and prints what each capture lost.
``python3 chip_smoke.py --head-bisect`` runs the whole main path with
a marked capture of one ``LMFeaturizer`` batch after each of phases
4–20 (``HeadProbe``) and two idle child processes that only capture
(``--head-clock-child every|late``), and prints each capture's lost
head beside the process's age.
``python3 chip_smoke.py --parent-overhead TREE`` times phase 20's
unarmed overhead arm on the ``tpudl_torch`` of ``TREE`` (a checkout of
an earlier commit) and on this one, a child process each, in the order
TREE, this, this, TREE.
``python3 chip_smoke.py --ranks N`` (N cards) runs phase 1 and
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

import atexit
import contextlib
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO_DIR = os.path.dirname(os.path.abspath(__file__))
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
# phase 3's ring hops at phase 16's shape: one causal ring over 4 entries
# of a 32768-token sequence, a hop wholly in the past (Q block 3 against K
# block 1) and a diagonal one (Q and K block 2)
RING_HOP_CASES = [("ring hop", (1, 8192, 16, 64), 8192, True, 24576, 8192),
                  ("ring diagonal", (1, 8192, 16, 64), 8192, True, 16384,
                   16384)]

# image slice: README's first example, sparkdl's flagship
IMAGE_MODEL = "InceptionV3"
IMAGE_ROWS, IMAGE_BATCH = 512, 64  # 8 batches at the model's 299×299
IMAGE_BIG = (480, 640)             # through the antialiased resize
IMAGE_BIG_ROWS = 256               # 4 batches at 480×640
IMAGE_WINDOWS = 2                  # timed windows of each rate (median, spread)
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
EXEC_WINDOWS = 2                   # timed windows of each executor arm
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
             ("serving", SLICE_SHAPE, SLICE_SHAPE[1], True, 0, 0),
             ("serve batcher", SERVE_BATCHER_SHAPE, SERVE_BATCHER_SHAPE[1],
              True, 0, 0),
             *RING_HOP_CASES]
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
             ("unaligned rows", (2, 70, 2, 32), 70, True, 0, 0),
             *RING_HOP_CASES]
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


def card_capture(body, cpu=True):
    """``body()`` under ``obs.trace.capture``, the one path every device
    reading here takes: ``(profiler, body's result)``. A truncated
    capture (its loss may reach the block) is refused and the reading
    taken once more."""
    from tpudl_torch.obs import trace as T

    for attempt in (1, 2):
        try:
            with T.capture(cpu=cpu) as prof:
                out = body()
            return prof, out
        except T.TruncatedCapture as e:
            if attempt == 2:
                raise
            print(f"    {e}; the reading is taken again", flush=True)


def timed_ms(fn):
    """A function that runs ``fn()`` and returns its wall ms, the card
    synchronized."""
    def run():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    return run


def card_kernels(prof):
    """The card's entries of a capture's ``key_averages()`` (every device
    reading here is an ``obs.trace.capture``), without its marker
    kernels."""
    from tpudl_torch.obs import trace as T

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and T.MARK_KERNEL not in e.key]


def profile_run(what, fn, top=6):
    """Where one run of ``fn`` spends the card's time: kernel time by
    name from torch.profiler, and its share of the run's wall time
    (measured under the profiler)."""
    prof, wall_ms = card_capture(timed_ms(fn))
    kernels = card_kernels(prof)
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
    prof, wall_ms = card_capture(timed_ms(fn))
    events = prof.key_averages()
    kernels = card_kernels(prof)
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
    kernel and copy the card ran, graph replays included, through a
    marked capture."""
    prof, wall_ms = card_capture(timed_ms(fn), cpu=False)
    if prof.capture["head_lost"]:
        print(f"    (the capture lost {prof.capture['head_lost']} device "
              "events at its head, all of them markers)", flush=True)
    dev = card_kernels(prof)
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


def interleaved_windows(stages, run, n, windows=IMAGE_WINDOWS):
    """Each arm's transform timed ``windows`` times, the arms in turn
    within each window, so that the host's noise falls on all of them
    alike; returns {arm: rates}, {arm: first output}, {arm: last
    report}."""
    from tpudl_torch.obs import last_pipeline_report

    rates = {arm: [] for arm in stages}
    first, reports = {}, {}
    for _ in range(windows):
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
    captures the fused arm's graph), EXEC_WINDOWS windows with the arms
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
        IMAGE_ROWS, EXEC_WINDOWS)
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
    bitwise equal to the serial arm's, and rows/s over EXEC_WINDOWS
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
                                      N_ROWS, EXEC_WINDOWS)
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
    from tpudl_torch.obs import trace as T

    prof, wall_ms = card_capture(timed_ms(fn))
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
            if T.MARK_KERNEL in k.name:
                continue
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
    if cls == "RandomUniform":
        return rng.uniform(c.get("minval", -0.05), c.get("maxval", 0.05),
                           shape)
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
    8192, rows/s over IMAGE_WINDOWS windows, and 64 rows card vs CPU."""
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


KERAS2_FIXTURES = os.path.join("tests", "fixtures", "keras2")
KERAS2_TEXT_ROWS, KERAS2_TEXT_BATCH = 65536, 8192
KERAS2_TEXT_CPU_ROWS = 64
KERAS2_TEXT_VOCAB_SEEN = 20000
KERAS2_MNV3_SIDE, KERAS2_MNV3_ROWS, KERAS2_MNV3_BATCH = 224, 256, 64
KERAS2_CPU_ROWS = 2
KERAS2_TRANSFORM_ROWS = 16
# the committed small models of tests/fixtures/keras2, card vs CPU: f32
# within phase 6's 2e-5 of max |y|; the bfloat16-policy model within 1e-2
# (bfloat16 keeps 8 bits; the CPU and the card round its products apart)
KERAS2_SMALL = ("text_cnn.h5", "text_layers.h5", "image_layers.h5",
                "attention.h5", "nested.h5", "groups.h5", "slash.h5",
                "bf16_policy.keras")
KERAS2_BF16_RTOL = 1e-2


def keras2_config(name):
    """A committed config of ``tests/fixtures/keras2`` (gz JSON): tf_keras's
    ``model_config`` (``*.keras2.config.json.gz``) or keras 3's
    ``config.json``."""
    import gzip

    here = os.path.dirname(os.path.abspath(__file__))
    with gzip.open(os.path.join(here, KERAS2_FIXTURES, name), "rt") as f:
        return json.load(f)


def keras2_text_weights(config, seed):
    """Seeded weights for keras-io's text classifier (a tf_keras config),
    each from its layer's initializer: the embedding uniform in ±0.05,
    Glorot-uniform kernels, zero biases."""
    from tpudl_torch.ingest.keras_legacy import keras3_config
    from tpudl_torch.ingest.kerasfile import layer_keys, model_layers

    rng = np.random.default_rng(seed)
    cfg = keras3_config(config)
    out, width = {}, None
    for layer in model_layers(cfg):
        cls, c = layer["class_name"], layer["config"]
        keys = layer_keys(layer, cfg, "h5")
        if cls == "Embedding":
            shapes = {"embeddings": (c["input_dim"], c["output_dim"])}
            inits = {"embeddings": c["embeddings_initializer"]}
            width = c["output_dim"]
        elif cls in ("Conv1D", "Dense"):
            n = c.get("filters") or c["units"]
            shapes = {"kernel": ((c["kernel_size"][0],) if cls == "Conv1D"
                                 else ()) + (width, n), "bias": (n,)}
            inits = {v: c[KERAS_INIT_KEYS[v]] for v in shapes}
            width = n
        elif keys:
            raise NotImplementedError(f"weights of a {cls} layer")
        for var, key in keys.items():
            out[key] = keras_initial(inits[var], shapes[var], rng).astype(
                np.float32)
    return out


def keras2_inception_leg(directory, card, problems):
    """configs[2] from a Keras 2 ``.h5``: tf_keras's InceptionV3 + head
    config written with phase 9's seeded, BN-perturbed weights, beside the
    same model as ``.keras``; the transformer over both bit for bit, the
    fit over each (cold, warm, steps/s; the trained file read back), and
    the first step's gradients against float64 on the card."""
    import keras2_h5_writer
    from tpudl_torch.image.imageIO import createNativeImageLoader
    from tpudl_torch.ingest.kerasfile import load_keras_file, save_keras_file
    from tpudl_torch.ml import KerasImageFileTransformer

    config = keras_inception_config()
    weights = keras_perturbed(keras_weights(config, SEED))
    t0 = time.perf_counter()
    h5 = keras2_h5_writer.write_keras2_h5(
        os.path.join(directory, "inception_tl.h5"),
        keras2_config("inception_v3_tl.keras2.config.json.gz"), weights)
    print(f"  wrote configs[2]'s InceptionV3 + head as a Keras 2 .h5 "
          f"({os.path.getsize(h5)} bytes, {len(weights)} variables) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    _cfg, back = load_keras_file(h5)
    print(f"  read it back with load_keras_file in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if list(back) != list(weights) or not all(
            np.array_equal(back[k], weights[k]) for k in weights):
        problems.append("the Keras 2 .h5 does not read back to its weights")
    path = save_keras_file(os.path.join(directory, "inception_tl.keras"),
                           config, weights)
    uris, labels = keras_jpegs(directory, KERAS_JPEGS, SEED)
    frame = keras_frame(uris, labels)
    loader = createNativeImageLoader(KERAS_SIDE, KERAS_SIDE,
                                     scale=1.0 / 255.0)
    head = keras_frame(uris[:KERAS2_TRANSFORM_ROWS])
    outs = {}
    for what, f in ((".h5", h5), (".keras", path)):
        outs[what] = np.stack(list(KerasImageFileTransformer(
            inputCol="uri", outputCol="out", modelFile=f,
            imageLoader=loader).transform(head)["out"]))
    same = np.array_equal(outs[".h5"], outs[".keras"])
    print(f"  KerasImageFileTransformer before training, {KERAS2_TRANSFORM_ROWS}"
          f" JPEGs: the Keras 2 .h5 against the .keras of the same weights "
          f"bit for bit: {same}; outputs {outs['.h5'].shape}")
    if not same or outs[".h5"].shape != (KERAS2_TRANSFORM_ROWS, 2):
        problems.append("the .h5 and .keras transformers differ")
    written = []
    X = y = None
    for what, f in ((".keras (as phase 9)", path), ("Keras 2 .h5", h5)):
        est, X, y, _m = keras_fit_leg(f"configs[2] InceptionV3+head from "
                                      f"{what}", f, frame, loader, card,
                                      problems, written)
    ref_loss, ref = keras_first_gradient(h5, loader, X, y, "cuda",
                                         torch.float64)
    loss, grads = keras_first_gradient(h5, loader, X, y, "cuda",
                                       torch.float32)
    top = max(np.abs(v).max() for v in ref.values())
    errs = {k: np.abs(grads[k] - ref[k]).max() / top for k in ref}
    worst = max(errs, key=errs.get)
    print(f"  the .h5's first-step gradients, card f32 against float64 on "
          f"the card ({len(ref)} variables, largest |g| {top:.4e}): loss "
          f"{loss - ref_loss:+.3e} off, gradients {errs[worst]:.3e} of the "
          f"largest at worst ({worst}) (limit {KERAS_GRAD_RTOL:g})")
    if not errs[worst] <= KERAS_GRAD_RTOL:
        problems.append(f".h5 first-step gradients {errs[worst]:.3e}")
    for f in written:
        if not f.endswith(".keras"):
            problems.append(f"a trained file {f} is not a .keras")
        if os.path.exists(f):
            os.remove(f)


def keras2_text_leg(directory, card, problems):
    """keras-io's text classifier from a Keras 2 ``.h5`` through
    ``KerasTransformer``: int64 ids of length 500, 65,536 rows at batch
    8192 (rows/s over IMAGE_WINDOWS windows), 64 rows against the CPU, and
    the dtype that reaches the graph."""
    import keras2_h5_writer
    from tpudl_torch.frame import Frame
    from tpudl_torch.ingest import input as ingest_input
    from tpudl_torch.ml import KerasTransformer

    config = keras2_config("text_classifier.keras2.config.json.gz")
    length = config["config"]["layers"][0]["config"]["batch_input_shape"][1]
    path = keras2_h5_writer.write_keras2_h5(
        os.path.join(directory, "text_classifier.h5"), config,
        keras2_text_weights(config, SEED))
    ids = np.random.default_rng(SEED).integers(
        0, KERAS2_TEXT_VOCAB_SEEN, (KERAS2_TEXT_ROWS, length),
        dtype=np.int64)
    seen = []
    make_fn = ingest_input.TFInputGraph.make_fn

    def spying(graph, *a, **k):
        fn = make_fn(graph, *a, **k)

        def run(*xs):
            seen.append(xs[-1].dtype)
            return fn(*xs)
        return run

    ingest_input.TFInputGraph.make_fn = spying
    try:
        kt = KerasTransformer(inputCol="x", outputCol="y", modelFile=path,
                              batchSize=KERAS2_TEXT_BATCH)
        kt.transform(Frame({"x": ids[:KERAS2_TEXT_BATCH]}))    # warm-up
        frame = Frame({"x": ids})
        rates, out = timed_windows(
            lambda: np.stack(list(kt.transform(frame)["y"])),
            KERAS2_TEXT_ROWS)
        cpu = KerasTransformer(inputCol="x", outputCol="y", modelFile=path,
                               batchSize=KERAS2_TEXT_BATCH, device="cpu")
        want = np.stack(list(cpu.transform(
            Frame({"x": ids[:KERAS2_TEXT_CPU_ROWS]}))["y"]))
    finally:
        ingest_input.TFInputGraph.make_fn = make_fn
    print(f"  keras-io text classifier (Embedding(20000, 128), 2 Conv1D(128,"
          f" 7, strides=3), GlobalMaxPooling1D, Dense) from a Keras 2 .h5, "
          f"KerasTransformer over {KERAS2_TEXT_ROWS} rows of {length} int64 "
          f"ids at batchSize {KERAS2_TEXT_BATCH}, {len(rates)} windows: "
          f"median {median(rates):.1f} rows/s (least {min(rates):.1f}, most "
          f"{max(rates):.1f}); the graph got {sorted(set(map(str, seen)))}; "
          f"card {card}", flush=True)
    if set(seen) != {torch.int64}:
        problems.append(f"text ids reached the graph as {set(seen)}")
    if out.shape != (KERAS2_TEXT_ROWS, 1) or not (
            (out > 0) & (out < 1)).all():
        problems.append(f"text classifier outputs {out.shape}")
    err = rel_err(out[:KERAS2_TEXT_CPU_ROWS], want)
    print(f"  text classifier card vs CPU, {KERAS2_TEXT_CPU_ROWS} rows: "
          f"{err:.3e} of max |y| {np.abs(want).max():.4g} (limit "
          f"{KERAS_CPU_RTOL:g})")
    if not err <= KERAS_CPU_RTOL:
        problems.append(f"text classifier card vs CPU {err:.3e}")


def keras2_mobilenet_v3_leg(directory, card, problems):
    """Keras 3's MobileNetV3Large (224x224, ``weights=None``, the committed
    config) through ``KerasImageFileTransformer``: images/s over 256 JPEGs,
    f32, and 2 rows with perturbed BN against the CPU."""
    from tpudl_torch.image.imageIO import createNativeImageLoader
    from tpudl_torch.ingest.kerasfile import save_keras_file
    from tpudl_torch.ml import KerasImageFileTransformer

    config = keras2_config("mobilenet_v3_large.config.json.gz")
    weights = keras_weights(config, SEED)
    path = save_keras_file(os.path.join(directory, "mnv3.keras"), config,
                           weights)
    uris = keras_app_jpegs(directory, KERAS2_MNV3_ROWS, KERAS2_MNV3_SIDE,
                           SEED)
    loader = createNativeImageLoader(KERAS2_MNV3_SIDE, KERAS2_MNV3_SIDE)
    kt = KerasImageFileTransformer(inputCol="uri", outputCol="out",
                                   modelFile=path, imageLoader=loader,
                                   batchSize=KERAS2_MNV3_BATCH)
    kt.transform(keras_frame(uris[:KERAS2_MNV3_BATCH]))     # warm-up
    frame = keras_frame(uris)
    rates, out = timed_windows(
        lambda: np.stack(list(kt.transform(frame)["out"])), KERAS2_MNV3_ROWS)
    print(f"  Keras 3 MobileNetV3Large ({len(weights)} variables) through "
          f"KerasImageFileTransformer, float32 at {KERAS2_MNV3_SIDE}x"
          f"{KERAS2_MNV3_SIDE}, batch {KERAS2_MNV3_BATCH}, {KERAS2_MNV3_ROWS}"
          f" JPEGs, {len(rates)} windows: median {median(rates):.1f} images/s"
          f" (least {min(rates):.1f}, most {max(rates):.1f}); card {card}",
          flush=True)
    if out.shape != (KERAS2_MNV3_ROWS, 1000) or not np.isfinite(out).all():
        problems.append(f"MobileNetV3Large outputs {out.shape}")
    pert = save_keras_file(os.path.join(directory, "mnv3_p.keras"), config,
                           keras_perturbed(weights))
    outs = {}
    head = keras_frame(uris[:KERAS2_CPU_ROWS])
    for device in ("cuda", "cpu"):
        outs[device] = np.stack(list(KerasImageFileTransformer(
            inputCol="uri", outputCol="out", modelFile=pert,
            imageLoader=loader, device=device).transform(head)["out"]))
    err = rel_err(outs["cuda"], outs["cpu"])
    print(f"  MobileNetV3Large card vs CPU, {KERAS2_CPU_ROWS} rows, perturbed "
          f"BN: {err:.3e} of max |y| {np.abs(outs['cpu']).max():.4g} (limit "
          f"{KERAS_CPU_RTOL:g})")
    if not err <= KERAS_CPU_RTOL:
        problems.append(f"MobileNetV3Large card vs CPU {err:.3e}")


def keras2_small_leg(card, problems):
    """Every committed small model of ``tests/fixtures/keras2`` (tf_keras's
    ``.h5`` files of the new layers, nested models, ``groups`` and slash
    names; keras 3's bfloat16-policy file) through the evaluator, card vs
    CPU on seeded inputs."""
    from tpudl_torch.device import full_f32
    from tpudl_torch.ingest import TFInputGraph

    here = os.path.dirname(os.path.abspath(__file__))
    for name in KERAS2_SMALL:
        gin = TFInputGraph.fromKeras(os.path.join(here, KERAS2_FIXTURES,
                                                  name))
        layers = gin.config["config"]["layers"]
        first = next(layer for layer in layers
                     if layer["class_name"] == "InputLayer")
        shape = tuple(first["config"]["batch_shape"][1:])
        rng = np.random.default_rng(SEED)
        dtype = gin.input_dtypes[0]
        if dtype.is_floating_point:
            x = torch.from_numpy((3 * rng.normal(size=(4,) + shape)).astype(
                np.float32))
        else:
            x = torch.from_numpy(rng.integers(0, 20, (4,) + shape)).to(dtype)
        fn = gin.make_fn()
        with torch.inference_mode(), full_f32():
            got = fn(x.cuda()).cpu().numpy()
            want = fn(x).numpy()
        limit = KERAS2_BF16_RTOL if "bf16" in name else GRAPH_RTOL
        err = rel_err(got, want)
        print(f"  {name} ({len(layers)} layers, {str(dtype)[6:]} input) card "
              f"vs CPU: {err:.3e} of max |y| {np.abs(want).max():.4g} (limit "
              f"{limit:g})")
        if not (got.shape == want.shape and err <= limit):
            problems.append(f"{name} card vs CPU {err:.3e}")
        if "bf16" not in name:
            keras2_gradient_check(os.path.join(here, KERAS2_FIXTURES, name),
                                  x, problems)


def keras2_gradient_check(path, x, problems):
    """Every variable's gradient of ``sum(y * r)`` (``r`` seeded) on the
    card in f32 against float64 on the card, within 1e-2 of the largest
    (phase 9's limit): the new layers' variables train."""
    from tpudl_torch.device import full_f32
    from tpudl_torch.ingest import TFInputGraph

    gin = TFInputGraph.fromKerasTrainable(path)
    fn, grads = gin.make_fn(), {}
    for dtype in (torch.float32, torch.float64):
        p = {k: torch.tensor(v, device="cuda", dtype=dtype,
                             requires_grad=True)
             for k, v in gin.params.items()}
        xd = x.cuda() if not x.dtype.is_floating_point else \
            x.to("cuda", dtype)
        with full_f32():
            y = fn(p, xd)
            r = torch.from_numpy(np.random.default_rng(SEED + 2).normal(
                size=y.shape)).to("cuda", dtype)
            (y * r).sum().backward()
        grads[dtype] = {k: t.grad.double().cpu().numpy()
                        for k, t in p.items()}
    ref = grads[torch.float64]
    top = max(np.abs(g).max() for g in ref.values())
    errs = {k: np.abs(grads[torch.float32][k] - g).max() / top
            for k, g in ref.items()}
    worst = max(errs, key=errs.get)
    print(f"    its gradients ({len(ref)} variables), card f32 against "
          f"float64 on the card: {errs[worst]:.3e} of the largest at worst "
          f"({worst}) (limit {KERAS_GRAD_RTOL:g})")
    if not errs[worst] <= KERAS_GRAD_RTOL:
        problems.append(f"{os.path.basename(path)} gradients "
                        f"{errs[worst]:.3e}")


def run_keras2_files(card):
    """Phase 12: the Keras files the port refused before, at full width.
    Every check runs and prints; the phase fails at its end if any did
    not hold."""
    import shutil
    import tempfile

    from tpudl_torch import cuda_ops

    t_phase = time.perf_counter()
    problems = []
    reset_launch_counts()
    directory = tempfile.mkdtemp(prefix="tpudl_keras2_smoke_")
    try:
        for leg in (keras2_inception_leg, keras2_text_leg,
                    keras2_mobilenet_v3_leg):
            t0 = time.perf_counter()
            leg(directory, card, problems)
            print(f"  {leg.__name__}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
        t0 = time.perf_counter()
        keras2_small_leg(card, problems)
        print(f"  keras2_small_leg: {time.perf_counter() - t0:.1f} s",
              flush=True)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    counts = dict(cuda_ops.launch_counts)
    print(f"  attention kernel launches in phase 12: {counts} (want 0)")
    if any(counts.values()):
        problems.append(f"phase 12 launched {counts}")
    print(f"  phase 12: {time.perf_counter() - t_phase:.1f} s; card {card}")
    if problems:
        fail("phase 12: " + "; ".join(problems))
    return counts


# phase 13, the data layer: the u8/bf16/token codecs, the shard cache, the
# device-memory batch cache and lm_dataset, under the executor, the stages,
# the estimator and the trainer, at full width
DATA_JPEGS, DATA_BATCH = 512, 64           # 8 batches of 299×299 JPEGs
DATA_CPU_ROWS = 2
DATA_CODEC_SHAPE = (512, 299, 299, 3)      # one prepared u8 image batch
DATA_LM_SEQ = TRAIN_SEQ                    # phase 4b's rows: 1025 tokens
DATA_LM_BATCH = 8                          # texts a batch = rows a batch
DATA_LM_STEPS = 5                          # an epoch; 2 epochs
DATA_LM_TEXT = DATA_LM_SEQ - 1             # bytes a text: + EOS = one row
DATA_BUDGET_MB = 64                        # below one arm (d) run's bytes


def data_counters() -> dict:
    """The data layer's and the image reader's counters now."""
    from tpudl_torch.obs import metrics

    names = ("imageio.uris_loaded", "imageio.files_read",
             "data.cache.hits", "data.cache.misses", "data.cache.puts",
             "data.cache.bytes_written", "data.cache.bytes_read",
             "data.hbm.hits", "data.hbm.puts", "data.hbm.evictions",
             "data.hbm.bytes_served", "data.hbm.put_failed",
             "data.wire.bytes_shipped", "data.wire.bytes_dense",
             "text.tokenize.calls")
    return {n: metrics.counter(n).value for n in names}


def data_delta(before) -> dict:
    now = data_counters()
    return {k: now[k] - before[k] for k in before}


def data_codec_leg(card, problems):
    """The codecs on the card: a 512×299×299×3 uint8 batch through U8Codec
    at scale 1, 1/255 and 1/255 with an offset, BF16Codec over the special
    values, TokenCodec u16 and i32 — each prologue on the card bit for bit
    its decode_array, and the wire bytes against dense f32."""
    from tpudl_torch.data import BF16Codec, U8Codec
    from tpudl_torch.data.codec import host_tensor
    from tpudl_torch.text import TokenCodec

    rng = np.random.default_rng(SEED)
    q = rng.integers(0, 256, DATA_CODEC_SHAPE, dtype=np.uint8)
    q_dev = torch.from_numpy(q).cuda()
    for scale, offset in ((1.0, 0.0), (1 / 255, 0.0), (1 / 255, 0.5)):
        c = U8Codec(scale, offset)
        got = c.prologue(q_dev).cpu().numpy()
        want = c.decode_array(q)
        same = np.array_equal(got.view(np.uint32), want.view(np.uint32))
        print(f"  U8Codec(scale={scale:.6g}, offset={offset}) on "
              f"{list(q.shape)}: card prologue bit for bit its decode_array:"
              f" {same}; wire {q.nbytes / 1e6:.1f} MB against dense f32 "
              f"{c.dense_nbytes(q) / 1e6:.1f} MB "
              f"({c.dense_nbytes(q) / q.nbytes:.0f}x)")
        if not same:
            problems.append(f"U8Codec({scale}, {offset}) prologue on the "
                            "card differs from decode_array")
    del q_dev
    bits = np.array([0, 0x80000000, 1, 0x807FFFFF, 0x7F800000, 0xFF800000,
                     0x7FC00000, 0xFFC00001, 0x3F808000, 0x3F818000,
                     0x7F7FFFFF], dtype=np.uint32).view(np.float32)
    x = np.concatenate([bits, rng.standard_normal(1 << 20).astype(
        np.float32) * 1e3])
    c = BF16Codec()
    enc = c.encode(x)
    got = c.prologue(host_tensor(enc).cuda()).cpu().numpy()
    same = np.array_equal(got.view(np.uint32),
                          c.decode_array(enc).view(np.uint32))
    print(f"  BF16Codec over {x.size} values (±0, subnormals, ±inf, NaN, "
          f"halfway cases, random): card prologue bit for bit its "
          f"decode_array: {same}; wire {enc.nbytes / 1e6:.2f} MB against "
          f"dense f32 {c.dense_nbytes(enc) / 1e6:.2f} MB "
          f"({c.dense_nbytes(enc) / enc.nbytes:.0f}x)")
    if not same:
        problems.append("BF16Codec prologue on the card differs")
    ids = rng.integers(0, 50257, (8, DATA_LM_SEQ)).astype(np.int32)
    for wire in ("u16", "i32"):
        c = TokenCodec(vocab_size=50257, wire_dtype=wire)
        enc = c.encode(ids)
        got = c.prologue(torch.from_numpy(enc).cuda()).cpu().numpy()
        same = np.array_equal(got, ids) and got.dtype == np.int32
        print(f"  TokenCodec(vocab 50257, wire {wire}) on {list(ids.shape)}"
              f": card prologue equals the int32 ids: {same}; wire "
              f"{enc.nbytes / 1e3:.1f} kB against int32 "
              f"{c.dense_nbytes(enc) / 1e3:.1f} kB")
        if not same:
            problems.append(f"TokenCodec {wire} prologue on the card")


def data_image_arms(directory, path, uris, card, problems):
    """configs[2]'s InceptionV3 + head over 512 JPEGs in four arms: (a) the
    float32 loader, (b) the uint8 loader (u8 codec), (c) (b) with cacheDir,
    cold then warm, (d) (c) with deviceCache. Returns (a)'s outputs, the
    stage of arm (d) and its cache directory."""
    from tpudl_torch.data import device_cache as dc
    from tpudl_torch.image.imageIO import createNativeImageLoader
    from tpudl_torch.ml import KerasImageFileTransformer
    from tpudl_torch.obs import last_pipeline_report

    f32 = createNativeImageLoader(KERAS_SIDE, KERAS_SIDE, scale=1 / 255)
    u8 = createNativeImageLoader(KERAS_SIDE, KERAS_SIDE, scale=1 / 255,
                                 output_dtype="uint8")
    cache = os.path.join(directory, "shards")

    def stage(loader, **kw):
        return KerasImageFileTransformer(
            inputCol="uri", outputCol="out", modelFile=path,
            imageLoader=loader, batchSize=DATA_BATCH, **kw)

    def run(st):
        return np.stack(list(st.transform(keras_frame(uris))["out"]))

    def arm_text(arm, what, rates, rep, extra=""):
        calls, secs = rep["stage_calls"], rep["stage_seconds"]
        return (f"  arm ({arm}), {what}: {DATA_JPEGS} JPEGs {KERAS_SIDE}x{KERAS_SIDE}, "
                f"batch {DATA_BATCH}, f32, {len(rates)} windows: median "
                f"{median(rates):.1f} images/s (least {min(rates):.1f}, most "
                f"{max(rates):.1f}); wire codec {rep['wire_codec']}, bytes "
                f"prepared {calls.get('bytes_prepared', 0)}, h2d "
                f"{secs.get('h2d', 0.0):.4f} s a run{extra}; card {card}")

    outs = {}
    a = stage(f32)
    a.transform(keras_frame(uris[:DATA_BATCH]))            # warm-up
    rates, outs["a"] = timed_windows(lambda: run(a), DATA_JPEGS)
    print(arm_text("a", "float32 loader", rates, last_pipeline_report()),
          flush=True)
    b = stage(u8)
    rates, outs["b"] = timed_windows(lambda: run(b), DATA_JPEGS)
    print(arm_text("b", "uint8 loader + u8 codec", rates,
                   last_pipeline_report()), flush=True)
    c = stage(u8, cacheDir=cache)
    before = data_counters()
    t0 = time.perf_counter()
    outs["c-cold"] = run(c)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    d_cold = data_delta(before)
    print(f"  arm (c), cacheDir, cold pass: {DATA_JPEGS / cold_s:.1f} "
          f"images/s; "
          f"decodes {d_cold['imageio.uris_loaded']:.0f}, shards written "
          f"{d_cold['data.cache.puts']:.0f} "
          f"({d_cold['data.cache.bytes_written'] / 1e6:.1f} MB)", flush=True)
    before = data_counters()
    rates, outs["c-warm"] = timed_windows(lambda: run(c), DATA_JPEGS)
    d_warm = data_delta(before)
    n = len(rates)
    print(arm_text(
        "c", "cacheDir, warm: a new Frame over the same files", rates,
        last_pipeline_report(),
        f"; over {n} passes: decodes {d_warm['imageio.uris_loaded']:.0f}, "
        f"files read {d_warm['imageio.files_read']:.0f}, shard hits "
        f"{d_warm['data.cache.hits'] / n:.0f} a pass, read "
        f"{d_warm['data.cache.bytes_read'] / n / 1e6:.1f} MB a pass"),
        flush=True)
    if d_warm["imageio.uris_loaded"] or d_warm["imageio.files_read"]:
        problems.append(f"the warm pass decoded: {d_warm}")
    if d_warm["data.cache.hits"] != n * DATA_JPEGS // DATA_BATCH:
        problems.append(f"warm shard hits {d_warm['data.cache.hits']} "
                        f"!= {n} x {DATA_JPEGS // DATA_BATCH}")
    dc.reset_device_cache()
    d = stage(u8, cacheDir=cache, deviceCache=True)
    run(d)                                      # becomes resident
    before = data_counters()
    rates, outs["d"] = timed_windows(lambda: run(d), DATA_JPEGS)
    d_res = data_delta(before)
    rep = last_pipeline_report()
    print(arm_text(
        "d", "cacheDir + deviceCache: resident", rates, rep,
        f"; over {n} passes: decodes {d_res['imageio.uris_loaded']:.0f}, "
        f"files read {d_res['imageio.files_read']:.0f}, resident hits "
        f"{d_res['data.hbm.hits'] / n:.0f} a pass, wire bytes shipped "
        f"{d_res['data.wire.bytes_shipped']:.0f}; resident "
        f"{dc.get_device_cache().bytes_resident / 1e6:.1f} MB"), flush=True)
    if d_res["imageio.uris_loaded"] or d_res["imageio.files_read"] or \
            d_res["data.wire.bytes_shipped"] or \
            rep["stage_calls"].get("bytes_prepared") or \
            rep["stage_seconds"].get("h2d"):
        problems.append(f"the resident pass shipped or decoded: {d_res}, "
                        f"{rep['stage_calls']}")
    for what in ("b", "c-cold", "c-warm", "d"):
        same = np.array_equal(outs[what], outs["a"])
        print(f"  arm ({what}) bit for bit arm (a): {same}")
        if not same:
            problems.append(f"arm ({what}) differs from arm (a): "
                            f"{rel_err(outs[what], outs['a']):.3e}")
    for what, st in (("a", a), ("c-warm", c)):
        print(idle_text(f"arm ({what})", *idle_profile(lambda: run(st)),
                        card))
    cpu = np.stack(list(stage(f32, device="cpu").transform(
        keras_frame(uris[:DATA_CPU_ROWS]))["out"]))
    err = rel_err(outs["c-warm"][:DATA_CPU_ROWS], cpu)
    print(f"  arm (c-warm) card vs CPU, {DATA_CPU_ROWS} rows: {err:.3e} of max "
          f"|y| (limit {IMAGE_CPU_RTOL:g})")
    if not err <= IMAGE_CPU_RTOL:
        problems.append(f"arm (c-warm) card vs CPU {err:.3e}")
    return outs["a"], stage, u8, cache


def data_budget_leg(uris, stage, u8, cache, want, card, problems):
    """The budget: budget_bytes() on this card, and arm (d) under
    TPUDL_DATA_HBM_BUDGET_MB below one run's bytes — another run's batches
    evict it, and it still equals arm (a)."""
    from tpudl_torch.data import device_cache as dc

    print(f"  budget_bytes() on this card: {dc.budget_bytes() / 1e9:.2f} GB "
          f"({dc.DEFAULT_BUDGET_FRACTION} of its memory); card {card}")
    os.environ["TPUDL_DATA_HBM_BUDGET_MB"] = str(DATA_BUDGET_MB)
    try:
        dc.reset_device_cache()
        d = stage(u8, cacheDir=cache, deviceCache=True)
        before = data_counters()
        first = np.stack(list(d.transform(keras_frame(uris))["out"]))
        other = uris[: len(uris) // 2]
        d.transform(keras_frame(other))          # another run's batches
        again = np.stack(list(d.transform(keras_frame(uris))["out"]))
        delta = data_delta(before)
        print(f"  TPUDL_DATA_HBM_BUDGET_MB={DATA_BUDGET_MB}: arm (d), a run "
              f"over half the files, arm (d) again: data.hbm puts "
              f"{delta['data.hbm.puts']:.0f}, hits {delta['data.hbm.hits']:.0f}"
              f", evictions {delta['data.hbm.evictions']:.0f}, put_failed "
              f"{delta['data.hbm.put_failed']:.0f}; resident "
              f"{dc.get_device_cache().bytes_resident / 1e6:.1f} MB of "
              f"{dc.get_device_cache().budget / 1e6:.1f} MB")
        same = np.array_equal(first, want) and np.array_equal(again, want)
        print(f"  arm (d) under the budget bit for bit arm (a): {same}")
        if not delta["data.hbm.evictions"] or not same:
            problems.append(f"budget leg: evictions "
                            f"{delta['data.hbm.evictions']}, equal {same}")
    finally:
        os.environ.pop("TPUDL_DATA_HBM_BUDGET_MB", None)
        dc.reset_device_cache()


def data_first_gradient(path, Xq, y, device, dtype):
    """The estimator's first-step loss and gradients on the u8 path: the
    first rows' uint8 pixels restored by the u8 codec on ``device``, then
    cast to ``dtype``."""
    from tpudl_torch.data import U8Codec
    from tpudl_torch.device import full_f32
    from tpudl_torch.ml.losses import get_loss

    gin = keras_estimator(path, None, device=device)._ingest()
    p = {k: torch.tensor(v, device=device, dtype=dtype, requires_grad=True)
         for k, v in gin.params.items()}
    xb = U8Codec(1 / 255).prologue(torch.from_numpy(
        Xq[:KERAS_CPU_BATCH]).to(device)).to(dtype)
    yb = torch.tensor(y[:KERAS_CPU_BATCH], device=device, dtype=dtype)
    with full_f32():
        loss = get_loss("categorical_crossentropy")(gin.make_fn()(p, xb), yb)
        loss.backward()
    return float(loss.detach()), {k: t.grad.double().cpu().numpy()
                                  for k, t in p.items()}


def data_estimator_leg(directory, uris, labels, card, problems):
    """configs[2] (96 JPEGs, batch 16, adam) with the uint8 loader,
    cacheDir and deviceCache: the first fit decodes 96 files, a second
    decodes none, both losses bit for bit a fit without the knobs; the
    time to fit beside phase 9's (the float32 loader, no knobs)."""
    from tpudl_torch.data import device_cache as dc
    from tpudl_torch.image.imageIO import createNativeImageLoader
    from tpudl_torch.ingest.kerasfile import save_keras_file
    from tpudl_torch.ml import KerasImageFileEstimator

    config = keras_inception_config()
    path = save_keras_file(os.path.join(directory, "inception_fit.keras"),
                           config, keras_weights(config, SEED))
    frame = keras_frame(uris[:KERAS_JPEGS], labels[:KERAS_JPEGS])
    u8 = createNativeImageLoader(KERAS_SIDE, KERAS_SIDE, scale=1 / 255,
                                 output_dtype="uint8")
    f32 = createNativeImageLoader(KERAS_SIDE, KERAS_SIDE, scale=1 / 255)
    written = []
    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        fits = {}
        for what, loader, kw in (
                ("phase 9's recipe: float32 loader", f32, {}),
                ("uint8 loader, no knobs", u8, {}),
                ("uint8 loader, cacheDir + deviceCache, cold", u8,
                 {"cacheDir": os.path.join(directory, "fit_shards"),
                  "deviceCache": True}),
                ("uint8 loader, cacheDir + deviceCache, warm", u8, None)):
            if kw is None:
                est = fits["uint8 loader, cacheDir + deviceCache, cold"][0]
            else:
                est = KerasImageFileEstimator(
                    inputCol="uri", outputCol="out", labelCol="label",
                    imageLoader=loader, modelFile=path,
                    kerasOptimizer="adam",
                    kerasLoss="categorical_crossentropy",
                    kerasFitParams={"epochs": 1, "batch_size": KERAS_BATCH},
                    **kw)
            before = data_counters()
            t0 = time.perf_counter()
            model = est.fit(frame)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            written.append(model.getModelFile())
            delta = data_delta(before)
            fits[what] = (est, model.history["step_loss"])
            print(f"  KerasImageFileEstimator configs[2], {KERAS_JPEGS} JPEGs,"
                  f" batch {KERAS_BATCH}, adam, {what}: fit {dt:.3f} s; "
                  f"decodes {delta['imageio.uris_loaded']:.0f}, shard hits "
                  f"{delta['data.cache.hits']:.0f}, resident puts "
                  f"{delta['data.hbm.puts']:.0f} hits "
                  f"{delta['data.hbm.hits']:.0f}; pinned after the fit "
                  f"{dc.get_device_cache().bytes_pinned} bytes; resident "
                  f"{dc.get_device_cache().bytes_resident / 1e6:.1f} MB; "
                  f"step losses {[round(v, 6) for v in model.history['step_loss']]}"
                  f"; card {card}", flush=True)
            want_decodes = 0 if kw is None else KERAS_JPEGS
            if delta["imageio.uris_loaded"] != want_decodes:
                problems.append(f"fit ({what}) decoded "
                                f"{delta['imageio.uris_loaded']}")
            if dc.get_device_cache().bytes_pinned:
                problems.append(f"fit ({what}) left its bulk pinned")
        plain = fits["uint8 loader, no knobs"][1]
        for what in ("uint8 loader, cacheDir + deviceCache, cold",
                     "uint8 loader, cacheDir + deviceCache, warm"):
            same = fits[what][1] == plain
            print(f"  losses of ({what}) bit for bit the fit without the "
                  f"knobs: {same}")
            if not same:
                problems.append(f"fit ({what}) losses differ")
    finally:
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = saved_det
        remove_files(written)
    est = fits["uint8 loader, no knobs"][0]
    Xq, y = est._getNumpyFeaturesAndLabels(frame)
    ref_loss, ref = data_first_gradient(path, Xq, y, "cuda", torch.float64)
    loss, grads = data_first_gradient(path, Xq, y, "cuda", torch.float32)
    top = max(np.abs(v).max() for v in ref.values())
    errs = {k: np.abs(grads[k] - ref[k]).max() / top for k in ref}
    worst = max(errs, key=errs.get)
    print(f"  first-step gradients on the u8 path, card f32 against float64 "
          f"({len(ref)} variables, largest |g| {top:.4e}): loss "
          f"{loss - ref_loss:+.3e} off, gradients {errs[worst]:.3e} of the "
          f"largest at worst ({worst}) (limit {KERAS_GRAD_RTOL:g})")
    if not errs[worst] <= KERAS_GRAD_RTOL:
        problems.append(f"u8-path first-step gradients {errs[worst]:.3e}")


def data_lm_texts(n, seed):
    """``n`` seeded texts of DATA_LM_TEXT bytes: each tokenizes to exactly
    one 1025-token row with its EOS, so a batch of 8 texts packs to 8 rows
    with no pad."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     ,.",
                            dtype=np.uint8)
    return np.array([rng.choice(letters, size=DATA_LM_TEXT).tobytes().decode()
                     for _ in range(n)], dtype=object)


def data_lm_training_leg(directory, card, problems):
    """phase 4b's model trained from lm_dataset (cache_dir, device_cache):
    2 epochs of 5 steps; epoch 2 tokenizes and ships nothing; 12 launches
    of each kernel a step; losses bit for bit the same steps fed int32
    tokens directly. Returns the kernel launches of the dataset's run."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.data import device_cache as dc
    from tpudl_torch.frame import Frame
    from tpudl_torch.text import ByteTokenizer, lm_dataset, tokenize_pack
    from tpudl_torch.train import Trainer, adamw
    from tpudl_torch.zoo.transformer import TinyCausalLM, load_jax_params

    tok = ByteTokenizer()
    texts = data_lm_texts(DATA_LM_BATCH * DATA_LM_STEPS, SEED + 5)
    ds = lm_dataset(Frame({"text": texts}), "text", tok,
                    seq_len=DATA_LM_SEQ, batch_size=DATA_LM_BATCH,
                    cache_dir=os.path.join(directory, "lm_shards"),
                    device_cache=True)
    print(f"  TinyCausalLM vocab {TRAIN_ARCH['vocab']} >= the tokenizer's "
          f"{tok.vocab_size}; wire {ds.plan.codecs[0].key()}; "
          f"{ds.num_batches} batches of {DATA_LM_BATCH} texts")
    if TRAIN_ARCH["vocab"] < tok.vocab_size or \
            ds.plan.codecs[0].wire != "u16":
        problems.append("the LM vocab or the wire type is wrong")
    lm = TinyCausalLM(**TRAIN_ARCH, device="cuda")
    weights = lm.init(SEED)
    load_jax_params(lm, weights)
    ref = TinyCausalLM(**TRAIN_ARCH, device="cuda")
    load_jax_params(ref, weights)
    pack = tokenize_pack(tok, seq_len=DATA_LM_SEQ, dense=True, eos=True)
    direct = [pack(texts[i * DATA_LM_BATCH:(i + 1) * DATA_LM_BATCH])
              for i in range(DATA_LM_STEPS)]
    if any(r.shape != (DATA_LM_BATCH, DATA_LM_SEQ) for r in direct):
        problems.append(f"batches of {[r.shape for r in direct]}")

    def epochs(model, loss_fn, data_fn):
        trainer = Trainer(loss_fn, adamw(LR), log_every=1)
        out = []
        opt = None
        for _ in range(2):
            before = data_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, opt, hist = trainer.fit(model, data_fn, DATA_LM_STEPS,
                                       opt_state=opt)
            torch.cuda.synchronize()
            out.append((hist, time.perf_counter() - t0, data_delta(before)))
        return out

    reset_launch_counts()
    runs = epochs(lm, ds.wrap(lm.loss_fn()),
                  lambda s: ds.get_batch(s % ds.num_batches))
    counts = dict(cuda_ops.launch_counts)
    base = epochs(ref, ref.loss_fn(), lambda s: direct[s % DATA_LM_STEPS])
    tokens = DATA_LM_STEPS * DATA_LM_BATCH * (DATA_LM_SEQ - 1)
    for what, r in (("lm_dataset, cache_dir + device_cache", runs),
                    ("int32 tokens fed directly", base)):
        for e, (hist, dt, delta) in enumerate(r, 1):
            print(f"  {what}, epoch {e}: {DATA_LM_STEPS} steps in {dt:.3f} "
                  f"s = {DATA_LM_STEPS / dt:.3f} steps/s, {tokens / dt:.0f} "
                  f"tokens/s; tokenize calls "
                  f"{delta['text.tokenize.calls']:.0f}, wire bytes shipped "
                  f"{delta['data.wire.bytes_shipped']:.0f}, resident hits "
                  f"{delta['data.hbm.hits']:.0f}; losses "
                  f"{[round(h['loss'], 6) for h in hist]}; card {card}")
    e2 = runs[1][2]
    if e2["text.tokenize.calls"] or e2["data.wire.bytes_shipped"] or \
            e2["data.hbm.hits"] != DATA_LM_STEPS:
        problems.append(f"lm_dataset epoch 2 was not resident: {e2}")
    want = TRAIN_ARCH["layers"] * 2 * DATA_LM_STEPS
    print(f"  kernel launches over the dataset's {2 * DATA_LM_STEPS} steps: "
          f"{counts} (want {want} of each)")
    if any(n != want for n in counts.values()):
        problems.append(f"lm_dataset training launched {counts}")
    ours = [h["loss"] for r in runs for h in r[0]]
    theirs = [h["loss"] for r in base for h in r[0]]
    print(f"  lm_dataset losses bit for bit the direct int32 feed: "
          f"{ours == theirs}")
    if ours != theirs or not ours[-1] < ours[0]:
        problems.append(f"lm_dataset losses {ours} vs {theirs}")
    del lm, ref
    dc.reset_device_cache()
    return counts


def data_featurizer_leg(directory, card, problems):
    """LMFeaturizer at phase 4's serving width with wireCodec="tokens" and
    cacheDir, cold then warm, against the uncached stage: the warm run
    tokenizes nothing, 12 forward launches a batch, features bit for bit.
    Returns the kernel launches of the warm run."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.frame import Frame
    from tpudl_torch.ml import LMFeaturizer
    from tpudl_torch.text import ByteTokenizer
    from tpudl_torch.zoo.transformer import TinyCausalLM

    spec = TinyCausalLM(VOCAB, DIM, HEADS, LAYERS, MAX_LEN, device="meta")
    weights = spec.init(SEED)
    texts = make_texts(N_ROWS, SEED)
    common = dict(inputCol="text", outputCol="vec", model=spec,
                  weights=weights, tokenizer=ByteTokenizer(),
                  batchSize=BATCH)
    plain = LMFeaturizer(**common)
    cached = LMFeaturizer(wireCodec="tokens",
                          cacheDir=os.path.join(directory, "text_shards"),
                          **common)
    plain.transform(Frame({"text": texts[:2]}))          # warm-up
    n_batches = -(-N_ROWS // BATCH)
    outs, counts = {}, {}
    for what, st in (("uncached", plain), ("cacheDir, cold", cached),
                     ("cacheDir, warm", cached)):
        before = data_counters()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[what] = np.stack(list(st.transform(
            Frame({"text": texts}))["vec"]))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts[what] = dict(cuda_ops.launch_counts)
        delta = data_delta(before)
        print(f"  LMFeaturizer {what}: {N_ROWS} rows in {dt:.3f} s = "
              f"{N_ROWS / dt:.1f} rows/s; tokenize calls "
              f"{delta['text.tokenize.calls']:.0f}, shard hits "
              f"{delta['data.cache.hits']:.0f}; flash launches "
              f"{counts[what]['flash_attn_fwd']} (want {LAYERS} x "
              f"{n_batches}); card {card}")
        if counts[what]["flash_attn_fwd"] != LAYERS * n_batches:
            problems.append(f"LMFeaturizer {what} launched {counts[what]}")
        if what == "cacheDir, warm" and delta["text.tokenize.calls"]:
            problems.append("the warm LMFeaturizer tokenized")
    for what in ("cacheDir, cold", "cacheDir, warm"):
        same = np.array_equal(outs[what], outs["uncached"])
        print(f"  LMFeaturizer {what} bit for bit the uncached stage: {same}")
        if not same:
            problems.append(f"LMFeaturizer {what} features differ")
    return counts["cacheDir, warm"]


def run_data_layer(card):
    """Phase 13: the data layer at full width. Every check runs and prints;
    the phase fails at its end if any did not hold. Returns the kernel
    launches of its two LM paths."""
    import shutil
    import tempfile

    from tpudl_torch import cuda_ops
    from tpudl_torch.data import device_cache as dc
    from tpudl_torch.ingest.kerasfile import save_keras_file

    t_phase = time.perf_counter()
    problems = []
    directory = tempfile.mkdtemp(prefix="tpudl_data_smoke_")
    try:
        t0 = time.perf_counter()
        data_codec_leg(card, problems)
        print(f"  data_codec_leg: {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        config = keras_inception_config()
        path = save_keras_file(
            os.path.join(directory, "inception_tl.keras"), config,
            keras_perturbed(keras_weights(config, SEED)))
        uris, labels = keras_jpegs(directory, DATA_JPEGS, SEED)
        print(f"  wrote the model and {DATA_JPEGS} JPEGs in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        reset_launch_counts()
        want, stage, u8, cache = data_image_arms(directory, path, uris, card,
                                                 problems)
        data_budget_leg(uris, stage, u8, cache, want, card, problems)
        print(f"  image arms and budget: {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        data_estimator_leg(directory, uris, labels, card, problems)
        print(f"  data_estimator_leg: {time.perf_counter() - t0:.1f} s",
              flush=True)
        image_counts = dict(cuda_ops.launch_counts)
        print(f"  attention kernel launches in the image legs: "
              f"{image_counts} (want 0)")
        if any(image_counts.values()):
            problems.append(f"the image legs launched {image_counts}")
        t0 = time.perf_counter()
        lm_counts = data_lm_training_leg(directory, card, problems)
        print(f"  data_lm_training_leg: {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        feat_counts = data_featurizer_leg(directory, card, problems)
        print(f"  data_featurizer_leg: {time.perf_counter() - t0:.1f} s",
              flush=True)
    finally:
        dc.reset_device_cache()
        shutil.rmtree(directory, ignore_errors=True)
    print(f"  phase 13: {time.perf_counter() - t_phase:.1f} s; card {card}")
    if problems:
        fail("phase 13: " + "; ".join(problems))
    return {"lm_dataset_training": lm_counts,
            "lm_featurize_cached": feat_counts}


# -- phase 14: the data-parallel mesh (PR 15) --------------------------------
MESH_DEVICE = "cuda:0"        # the card of the one-card mesh and rehearsal
MESH_FUSE = 4
MESH_LM_ROWS = 69             # 5 batches of 16: the tail of 5 pads to 2
# of max |y|: f32 as phase 6 holds images; a bf16 shard at half the batch
# runs other cuDNN bf16 algorithms, each product rounded to 8 bits (one
# bf16 ulp is 2^-8 = 3.9e-3), so bf16 is held to ~2.5 ulps
MESH_IMAGE_RTOL = {"float32": IMAGE_CPU_RTOL, "bfloat16": 1e-2}
MESH_LM_RTOL = 1e-4                # of max |y|, phase 4's 1e-4
MESH_TRIAL_JPEGS = 32
MESH_DATASET_ROWS = 512
MESH_GRAD_STEPS = 3           # adam steps whose gradients are held


def mesh_cases():
    """The meshes of phase 14: ``(label, mesh, exact)``. A one-card mesh
    (held bit for bit to the run without a mesh), the one-card rehearsal
    of two entries, and, where more than one card is visible, the mesh of
    every card."""
    from tpudl_torch import mesh as M

    cases = [("one-card mesh", M.build_mesh(devices=[MESH_DEVICE]), True),
             ("2 entries of one card",
              M.build_mesh(devices=[MESH_DEVICE, MESH_DEVICE]), False)]
    n = torch.cuda.device_count()
    if n > 1:
        cases.append((f"{n}-card mesh", M.build_mesh(
            devices=[f"cuda:{i}" for i in range(n)]), False))
    return cases


def mesh_image_leg(card, cases, problems):
    """``DeepImageFeaturizer("InceptionV3")`` over IMAGE_ROWS structs at
    299x299 in f32 and bf16: each mesh's stage (and its fuseSteps arm)
    against the stage without a mesh, and images/s of every arm over
    IMAGE_WINDOWS windows with the arms in turn. Returns {dtype: {arm:
    median images/s}}."""
    from tpudl_torch.frame import Frame
    from tpudl_torch.ml import DeepImageFeaturizer
    from tpudl_torch.obs import last_pipeline_report

    frame = Frame({"image": image_structs(IMAGE_ROWS, (299, 299, 3), SEED)})
    common = dict(inputCol="image", outputCol="f", modelName=IMAGE_MODEL,
                  weights="random", batchSize=IMAGE_BATCH)
    medians = {}
    for dtype_name in ("float32", "bfloat16"):
        stages = {"mesh=None": DeepImageFeaturizer(
            computeDtype=dtype_name, device=MESH_DEVICE, **common),
            "mesh=None, fused": DeepImageFeaturizer(
                computeDtype=dtype_name, device=MESH_DEVICE,
                fuseSteps=MESH_FUSE, **common)}
        for label, mesh, _exact in cases:
            stages[label] = DeepImageFeaturizer(
                computeDtype=dtype_name, mesh=mesh, **common)
            if label != "2 entries of one card":
                stages[f"{label}, fused"] = DeepImageFeaturizer(
                    computeDtype=dtype_name, mesh=mesh, fuseSteps=MESH_FUSE,
                    **common)
        ys, reports = {}, {}
        for arm, stage in stages.items():
            t0 = time.perf_counter()
            ys[arm] = np.stack(list(stage.transform(frame)["f"]))
            torch.cuda.synchronize()
            reports[arm] = last_pipeline_report()
            print(f"  {IMAGE_MODEL} {dtype_name} {arm}: first transform "
                  f"(loads, replicates, captures) "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
        with executor_arm("serial"):
            serial = np.stack(list(stages["one-card mesh"].transform(
                frame)["f"]))
        want = ys["mesh=None"]
        for arm, y in ys.items():
            if y.shape != want.shape or not np.isfinite(y).all():
                problems.append(f"image {dtype_name} {arm}: output "
                                f"{y.shape}")
                continue
            if arm.startswith("mesh=None"):
                continue
            if arm in ("one-card mesh", "one-card mesh, fused"):
                ref = "mesh=None" + arm[len("one-card mesh"):]
                same = np.array_equal(y, ys[ref])
                print(f"  {dtype_name} {arm} bit for bit {ref}: {same}")
                if not same:
                    problems.append(f"image {dtype_name} {arm} differs from "
                                    f"{ref} by {rel_err(y, ys[ref]):.3e}")
                continue
            err = rel_err(y, want)
            print(f"  {dtype_name} {arm} against mesh=None: {err:.3e} of max"
                  f" |y| (limit {MESH_IMAGE_RTOL[dtype_name]:g})")
            if not err <= MESH_IMAGE_RTOL[dtype_name]:
                problems.append(f"image {dtype_name} {arm} {err:.3e}")
        print(f"  {dtype_name} one-card mesh, fused against its serial arm: "
              + check_arm_output(f"image {dtype_name} one-card mesh, fused",
                                 ys["one-card mesh, fused"], serial, card))
        for arm, rep in reports.items():
            if "fused" in arm and not rep["stage_calls"].get(
                    "fused_dispatches"):
                problems.append(f"image {dtype_name} {arm} fused nothing")
        rates, _, _ = interleaved_windows(
            stages, lambda st: np.stack(list(st.transform(frame)["f"])),
            IMAGE_ROWS)
        medians[dtype_name] = {}
        for arm, r in rates.items():
            medians[dtype_name][arm] = median(r)
            print(f"  {IMAGE_MODEL} {dtype_name} {arm}: {len(r)} windows "
                  f"(arms in turn): median {median(r):.1f} images/s (least "
                  f"{min(r):.1f}, most {max(r):.1f}); mesh "
                  f"{reports[arm]['mesh']}; card {card}")
    return medians


def mesh_lm_leg(card, cases, problems):
    """``LMFeaturizer`` at phase 4's width over MESH_LM_ROWS texts, batch
    BATCH: each mesh against the stage without a mesh, the flash forward
    launches of a counted run (LAYERS a batch on every entry), the
    fused arm on the one-card mesh, and the report's pad rows on the
    ragged tail. Returns {path: launch counts} of the counted runs."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.frame import Frame
    from tpudl_torch.ml import LMFeaturizer
    from tpudl_torch.obs import last_pipeline_report
    from tpudl_torch.text import ByteTokenizer
    from tpudl_torch.zoo.transformer import TinyCausalLM

    spec = TinyCausalLM(VOCAB, DIM, HEADS, LAYERS, MAX_LEN, device="meta")
    weights = spec.init(SEED)
    frame = Frame({"text": make_texts(MESH_LM_ROWS, SEED)})
    n_batches = -(-MESH_LM_ROWS // BATCH)
    common = dict(inputCol="text", outputCol="v", model=spec,
                  weights=weights, tokenizer=ByteTokenizer(),
                  batchSize=BATCH)
    arms = [("mesh=None", None, {}), ("one-card mesh, fused", cases[0][1],
                                     {"fuseSteps": MESH_FUSE})]
    arms += [(label, mesh, {}) for label, mesh, _ in cases]
    ys, counts = {}, {}
    for arm, mesh, knobs in arms:
        where = {"mesh": mesh} if mesh is not None else \
            {"device": MESH_DEVICE}
        stage = LMFeaturizer(**common, **where, **knobs)
        stage.transform(frame)             # loads, replicates, captures
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        ys[arm] = y = np.stack(list(stage.transform(frame)["v"]))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rep = last_pipeline_report()
        counts[arm] = dict(cuda_ops.launch_counts)
        entries = 1 if mesh is None else mesh.size
        want = LAYERS * n_batches * entries
        pad = 0 if mesh is None else (-(MESH_LM_ROWS % BATCH)) % mesh.size
        print(f"  LMFeaturizer {arm}: {MESH_LM_ROWS / dt:.1f} rows/s; flash "
              f"forward launches {counts[arm]['flash_attn_fwd']} (want "
              f"{LAYERS} x {n_batches} batches x {entries} entries); report "
              f"mesh {rep['mesh']}, mesh_pad_rows_max "
              f"{rep.get('mesh_pad_rows_max')} (want {pad if mesh else None})"
              f", fused {rep['stage_calls'].get('fused_dispatches', 0)}; "
              f"card {card}", flush=True)
        if counts[arm]["flash_attn_fwd"] != want or \
                counts[arm]["flash_attn_bwd_dq"] or \
                counts[arm]["flash_attn_bwd_dkv"]:
            problems.append(f"LMFeaturizer {arm} launches {counts[arm]}")
        if mesh is not None and (rep["mesh"] != mesh.shape
                                 or rep["mesh_pad_rows_max"] != pad):
            problems.append(f"LMFeaturizer {arm} report {rep['mesh']} "
                            f"{rep.get('mesh_pad_rows_max')}")
        if "fused" in arm and not rep["stage_calls"].get("fused_dispatches"):
            problems.append(f"LMFeaturizer {arm} fused nothing")
        if y.shape != (MESH_LM_ROWS, DIM) or not np.isfinite(y).all():
            problems.append(f"LMFeaturizer {arm} output {y.shape}")
    want = ys["mesh=None"]
    for arm, y in ys.items():
        if arm == "mesh=None":
            continue
        if arm == "one-card mesh":
            same = np.array_equal(y, want)
            print(f"  LMFeaturizer one-card mesh bit for bit mesh=None: "
                  f"{same}")
            if not same:
                problems.append(f"LMFeaturizer one-card mesh differs by "
                                f"{rel_err(y, want):.3e}")
            continue
        if arm == "one-card mesh, fused":
            print("  LMFeaturizer one-card mesh, fused: " + check_arm_output(
                "LMFeaturizer one-card mesh, fused", y, ys["one-card mesh"],
                card))
            continue
        err = rel_err(y, want)
        print(f"  LMFeaturizer {arm} against mesh=None: {err:.3e} of max "
              f"|y| (limit {MESH_LM_RTOL:g})")
        if not err <= MESH_LM_RTOL:
            problems.append(f"LMFeaturizer {arm} {err:.3e}")
    return {"mesh_one_card": counts["one-card mesh"],
            "mesh_two_entries": counts["2 entries of one card"]}


def mesh_gradient_check(path, X, y, mesh, card, problems, label):
    """The gradients of the data-parallel step over ``mesh`` (each entry's
    weighted shard loss backpropagated into its replica, summed onto the
    first entry: the estimator's ``sharded_backward``) on the rows ``X,
    y``, before each of MESH_GRAD_STEPS adam steps (the fit's: the step on
    the first entry, the weights broadcast to the others), against a
    float64 run of the whole batch on one card at the same weights. Over
    several cards this is where the cross-card sums and broadcasts would
    show a fault in an adam fit."""
    from tpudl_torch import mesh as M
    from tpudl_torch.device import full_f32
    from tpudl_torch.ml.estimator import sharded_backward
    from tpudl_torch.ml.losses import (get_loss, get_optimizer_dynamic,
                                       set_learning_rate)

    gin = keras_estimator(path, None, device=MESH_DEVICE)._ingest()
    loss_fn, apply_fn = get_loss("categorical_crossentropy"), gin.make_fn()
    devices = mesh.devices
    params = {k: torch.tensor(v, device=devices[0], requires_grad=True)
              for k, v in gin.params.items()}
    factory, lr = get_optimizer_dynamic("adam")
    opt = factory(list(params.values()))
    set_learning_rate(opt, lr)
    replicas = [params] + [{k: t.detach().to(d, copy=True).requires_grad_()
                            for k, t in params.items()} for d in devices[1:]]
    x64 = torch.tensor(X, device=MESH_DEVICE, dtype=torch.float64)
    y64 = torch.tensor(y, device=MESH_DEVICE, dtype=torch.float64)
    for step in range(MESH_GRAD_STEPS):
        p64 = {k: t.detach().to(MESH_DEVICE, torch.float64)
               .requires_grad_() for k, t in params.items()}
        with torch.enable_grad(), full_f32():
            loss64 = loss_fn(apply_fn(p64, x64), y64)
            loss64.backward()
            grads, loss = sharded_backward(
                apply_fn, loss_fn, replicas, M.shard_batch((X, y), mesh),
                devices)
        ref = {k: t.grad.cpu().numpy() for k, t in p64.items()}
        top = max(np.abs(v).max() for v in ref.values())
        errs = {k: float(np.abs(grads[k].double().cpu().numpy() - ref[k])
                         .max() / top) for k in ref}
        worst = max(errs, key=errs.get)
        print(f"  {label}: gradients of the data-parallel step before adam "
              f"step {step + 1} against float64 on one card ({len(ref)} "
              f"variables, largest |g| {top:.4e}): loss "
              f"{float(loss) - float(loss64.detach()):+.3e} off, gradients "
              f"{errs[worst]:.3e} of the largest at worst ({worst}) (limit "
              f"{KERAS_GRAD_RTOL:g}); card {card}")
        if not errs[worst] <= KERAS_GRAD_RTOL:
            problems.append(f"{label} step {step + 1} gradients "
                            f"{errs[worst]:.3e}")
        for k, g in grads.items():
            params[k].grad = g
        opt.step()
        M.broadcast(list(params.values()),
                    [list(rep.values()) for rep in replicas], devices)


def mesh_fit_leg(directory, card, cases, problems):
    """configs[2]'s ``KerasImageFileEstimator.fit`` (KERAS_JPEGS JPEGs,
    batch KERAS_BATCH, adam) over each mesh of two or more entries
    against the fit on one card (losses within KERAS_LOSS_ATOL), its
    first-step gradients against float64, and ``fitMultiple`` with 2
    trials over the 2-entry mesh. Over several cards the adam fit's
    losses are printed and an sgd fit's are held: adam's first steps
    move every variable by ~lr·sign(g), so a gradient near 0 summed in
    another order (four shards of 4 rows, NCCL's reduce) can move the
    other way, as phase 9 found for adam between card and CPU."""
    from tpudl_torch.image.imageIO import createNativeImageLoader
    from tpudl_torch.ingest.kerasfile import save_keras_file
    from tpudl_torch.ml import KerasImageFileEstimator

    config = keras_inception_config()
    path = save_keras_file(os.path.join(directory, "inception_mesh.keras"),
                           config, keras_weights(config, SEED))
    uris, labels = keras_jpegs(directory, KERAS_JPEGS, SEED)
    frame = keras_frame(uris, labels)
    loader = createNativeImageLoader(KERAS_SIDE, KERAS_SIDE, scale=1 / 255)
    written = []
    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    def estimator(optimizer="adam", **kw):
        return KerasImageFileEstimator(
            inputCol="uri", outputCol="out", labelCol="label",
            imageLoader=loader, modelFile=path, kerasOptimizer=optimizer,
            kerasLoss="categorical_crossentropy",
            kerasFitParams={"epochs": 1, "batch_size": KERAS_BATCH}, **kw)

    def where(mesh):
        return {"mesh": mesh} if mesh is not None else \
            {"device": MESH_DEVICE}

    try:
        fits = {}
        for label, mesh, _exact in [("one card", None, True)] + cases[1:]:
            est = estimator(**where(mesh))
            for what in ("cold", "warm"):
                t0 = time.perf_counter()
                model = est.fit(frame)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                written.append(model.getModelFile())
            fits[label] = model.history["step_loss"]
            print(f"  configs[2] fit over {label} ({KERAS_JPEGS} JPEGs, batch"
                  f" {KERAS_BATCH}, adam): warm {dt:.3f} s; step losses "
                  f"{[round(v, 6) for v in fits[label]]}; card {card}",
                  flush=True)
            if not np.isfinite(fits[label]).all():
                problems.append(f"fit over {label}: losses not finite")
            if mesh is None:
                continue
            err = float(np.abs(np.subtract(fits[label],
                                           fits["one card"])).max())
            held = len(mesh.distinct_devices()) == 1
            limit = (f"limit {KERAS_LOSS_ATOL:g}" if held
                     else "printed: adam")
            print(f"  fit over {label} against one card: losses {err:.3e} "
                  f"off at most ({limit})")
            if held and not err <= KERAS_LOSS_ATOL:
                problems.append(f"fit over {label} losses {err:.3e}")
            if not held:
                sgd = {}
                for who, m in (("one card", None), (label, mesh)):
                    fit = estimator("sgd", **where(m)).fit(frame)
                    written.append(fit.getModelFile())
                    sgd[who] = fit.history["step_loss"]
                err = float(np.abs(np.subtract(sgd[label],
                                               sgd["one card"])).max())
                print(f"  sgd fit over {label} against one card: losses "
                      f"{err:.3e} off at most (limit {KERAS_LOSS_ATOL:g})")
                if not err <= KERAS_LOSS_ATOL:
                    problems.append(f"sgd fit over {label} losses {err:.3e}")
            # KERAS_CPU_BATCH rows, rounded up to split over the mesh
            rows = -(-KERAS_CPU_BATCH // mesh.size) * mesh.size
            X, y = est._getNumpyFeaturesAndLabels(frame.head(rows))
            mesh_gradient_check(path, X, y, mesh, card, problems, label)
        mesh2 = cases[1][1]
        est = estimator(mesh=mesh2)
        small = keras_frame(uris[:MESH_TRIAL_JPEGS],
                            labels[:MESH_TRIAL_JPEGS])
        maps = [{est.kerasFitParams: {"epochs": 1, "batch_size": KERAS_BATCH,
                                      "learning_rate": lr}}
                for lr in SURFACE_LRS]
        t0 = time.perf_counter()
        trials = dict(est.fitMultiple(small, maps))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        written += [m.getModelFile() for m in trials.values()]
        for i, pm in enumerate(maps):
            solo = estimator(device=MESH_DEVICE).copy(pm).fit(small)
            written.append(solo.getModelFile())
            err = float(np.abs(np.subtract(trials[i].history["step_loss"],
                                           solo.history["step_loss"])).max())
            print(f"  fitMultiple over 2 entries, trial {i} (lr "
                  f"{SURFACE_LRS[i]:g}, a 1-entry slice): losses "
                  f"{trials[i].history['step_loss']}, {err:.3e} off a plain "
                  f"fit (limit {KERAS_LOSS_ATOL:g}); mesh of its model "
                  f"{trials[i].mesh.shape}", flush=True)
            if not err <= KERAS_LOSS_ATOL or trials[i].mesh is not mesh2:
                problems.append(f"fitMultiple trial {i}: {err:.3e}")
        print(f"  fitMultiple: 2 trials in {dt:.2f} s; card {card}")
    finally:
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = saved_det
        remove_files(written)


def mesh_dataset_leg(card, cases, problems):
    """``Dataset(mesh=, device_cache=True)`` over MESH_DATASET_ROWS uint8
    rows at 299x299x3, batch IMAGE_BATCH, the u8 codec, over each mesh of
    two or more entries: epoch 1 places each batch as its shards, epoch 2
    replays them on the card with 0 bytes shipped, every shard's rows bit
    for bit the host batch's."""
    from tpudl_torch import mesh as M
    from tpudl_torch.data import Dataset
    from tpudl_torch.data import device_cache as dc
    from tpudl_torch.frame import Frame

    x = np.random.default_rng(SEED).integers(
        0, 256, (MESH_DATASET_ROWS, 299, 299, 3), dtype=np.uint8)
    n_batches = MESH_DATASET_ROWS // IMAGE_BATCH
    for label, mesh, _exact in cases[1:]:
        dc.reset_device_cache()
        ds = Dataset(Frame({"x": x}), ["x"], batch_size=IMAGE_BATCH,
                     wire_codec="u8", device_cache=True, mesh=mesh)
        before = data_counters()
        list(ds.iter_epoch(0))
        first = data_delta(before)
        before = data_counters()
        again = [b[0] for b in ds.iter_epoch(1)]
        torch.cuda.synchronize()
        second = data_delta(before)
        on_card = all(isinstance(b, M.Sharded) and b.devices == list(
            mesh.devices) for b in again)
        same = all(np.array_equal(torch.cat([t.cpu() for t in b]).numpy(),
                                  x[i * IMAGE_BATCH:(i + 1) * IMAGE_BATCH])
                   for i, b in enumerate(again))
        print(f"  Dataset over {label}: epoch 1 shipped "
              f"{first['data.wire.bytes_shipped']:.0f} bytes, puts "
              f"{first['data.hbm.puts']:.0f}; epoch 2 shipped "
              f"{second['data.wire.bytes_shipped']:.0f} bytes, hits "
              f"{second['data.hbm.hits']:.0f} (want 0 and {n_batches}); "
              f"batches as per-entry shards on the mesh's cards: {on_card};"
              f" rows bit for bit the host's: {same}; card {card}")
        if second["data.wire.bytes_shipped"] or \
                second["data.hbm.hits"] != n_batches or not on_card \
                or not same:
            problems.append(f"Dataset over {label}: {second}, on card "
                            f"{on_card}, same {same}")
    dc.reset_device_cache()


def mesh_kernel_cards(card, problems):
    """The forward kernel against its plain version on every visible card
    at the serving shape, f32 and bf16, with phase 3's limits."""
    from tpudl_torch import cuda_ops

    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        gen = torch.Generator().manual_seed(SEED + i)
        for dtype in (torch.float32, torch.bfloat16):
            tol = TOL[str(dtype).split(".")[1]]
            q, k, v = (torch.randn(*SLICE_SHAPE, generator=gen).to(dev, dtype)
                       for _ in range(3))
            with torch.cuda.device(dev):
                o, lse = cuda_ops.flash_attention(q, k, v, causal=True,
                                                  return_lse=True)
                po, plse = cuda_ops.flash_attention_plain(
                    q, k, v, causal=True, return_lse=True)
                torch.cuda.synchronize()
            diff = (o.float() - po.float()).abs()
            lse_abs = float((lse - plse).abs().max())
            ok = (bool((diff <= tol["o_abs"]
                        + tol["o_rel"] * po.float().abs()).all())
                  and lse_abs <= tol["lse_abs"])
            print(f"  flash forward on {dev} {str(dtype)[6:]}: O max abs "
                  f"{float(diff.max()):.3e}, lse {lse_abs:.3e} "
                  f"{'ok' if ok else 'MISS'}")
            if not ok:
                problems.append(f"flash forward on {dev} ({dtype})")


def run_mesh(card):
    """Phase 14: the data-parallel mesh at full width. Every check runs
    and prints; the phase fails at its end if any did not hold. Returns
    the kernel launches of its LM paths."""
    import shutil
    import tempfile

    from tpudl_torch import cuda_ops

    t_phase = time.perf_counter()
    problems = []
    cases = mesh_cases()
    print(f"  meshes: {[(label, [str(d) for d in m.devices]) for label, m, _ in cases]}")
    directory = tempfile.mkdtemp(prefix="tpudl_mesh_smoke_")
    try:
        if torch.cuda.device_count() > 1:
            mesh_kernel_cards(card, problems)
        t0 = time.perf_counter()
        reset_launch_counts()
        medians = mesh_image_leg(card, cases, problems)
        image_counts = dict(cuda_ops.launch_counts)
        print(f"  mesh_image_leg: {time.perf_counter() - t0:.1f} s; "
              f"attention kernel launches {image_counts} (want 0)",
              flush=True)
        if any(image_counts.values()):
            problems.append(f"the image leg launched {image_counts}")
        for dtype_name, m in medians.items():
            base = m["mesh=None"]
            for arm, rate in m.items():
                print(f"  {dtype_name} {arm}: {rate / base:.3f}x the median "
                      f"of mesh=None")
            if len(cases) > 2:    # the mesh of every card against one card
                many = cases[2][0]
                for suffix in ("", ", fused"):
                    print(f"  {dtype_name} scaling{suffix or ', unfused'}: "
                          f"{many}{suffix} {m[many + suffix]:.1f} images/s, "
                          f"{m[many + suffix] / m['one-card mesh' + suffix]:.3f}"
                          f"x the one-card mesh{suffix}; card {card}")
        t0 = time.perf_counter()
        lm_counts = mesh_lm_leg(card, cases, problems)
        print(f"  mesh_lm_leg: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        mesh_fit_leg(directory, card, cases, problems)
        print(f"  mesh_fit_leg: {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        mesh_dataset_leg(card, cases, problems)
        print(f"  mesh_dataset_leg: {time.perf_counter() - t0:.1f} s",
              flush=True)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    print(f"  phase 14: {time.perf_counter() - t_phase:.1f} s; card {card}")
    if problems:
        fail("phase 14: " + "; ".join(problems))
    return lm_counts



# phase 15: serving (tpudl_torch.serve) at phase 4's width
SERVE_SLOTS, SERVE_CACHE = 8, 1024
SERVE_MAX_NEW = 32
SERVE_PARITY_PLENS = (5, 9, 17, 33, 65, 100, 200, 300)
SERVE_CPU_PROMPTS = 2              # of the parity prompts, against the CPU
SERVE_CHURN_PLENS = (7, 12, 24, 48, 96, 150)   # x 4 = 24 requests, 3 cycles
SERVE_CHURN_REPEATS = 4
SERVE_TEMPERATURE, SERVE_SAMPLE_SEED = 0.8, 1234
SERVE_LOAD_REQUESTS, SERVE_CLIENTS = 32, 8
SERVE_LOAD_PLEN = (16, 256)
SERVE_SERIAL_EVERY = 4             # serial eager generate: every 4th prompt
SERVE_LOGIT_RTOL = 1e-4            # of max |logit|: replay vs eager step
SERVE_BATCHER_ROWS = (3, 5, 11)    # ragged payloads, 19 rows → rung 24
SERVE_BATCHER_BYTES = 255          # + BOS = 256 tokens a row
# [B, S, H, D] the batcher's dispatch gives every decoder block (phase 3
# holds the kernel there)
SERVE_BATCHER_SHAPE = (24, SERVE_BATCHER_BYTES + 1, 16, 64)
SERVE_TIMEOUT = 300                # every wait on a request or the loop
SERVE_DEADLINE_S = 0.1             # < 960 decode steps, > a 16-token prefill
_ATTN_OPS = {"aten::einsum", "aten::bmm", "aten::_softmax", "aten::softmax",
             "aten::masked_fill", "aten::masked_fill_", "aten::index_put_",
             "aten::_index_put_impl_", "aten::index_copy_", "aten::le",
             "aten::bitwise_not", "aten::arange"}
SERVE_OP_GROUPS = (  # (group, test on (ops from the launching one up, kernel))
    ("weight GEMMs (q/k/v/o, MLP, head)",
     lambda ops, k: bool({"aten::mm", "aten::addmm"} & set(ops))
     and "aten::einsum" not in ops),
    ("cached attention (write, scores, mask, softmax, P.V)",
     lambda ops, k: bool(_ATTN_OPS & set(ops))),
    ("other (embedding, norms, gelu, adds, copies)", lambda ops, k: True),
)


class _Probe:
    """A request for the engine's own verbs (no queue): a prompt and its
    new-token count."""

    def __init__(self, prompt, max_new, rng=None):
        self.prompt = np.asarray(prompt, dtype=np.int32)[None, :]
        self.max_new = int(max_new)
        self.rng = rng
        self.trace = None


def serve_prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=int(n)).astype(np.int32)
            for n in lengths]


def serve_serial(net, prompt, max_new, **kw):
    """The port's serial batch-1 ``generate`` of one prompt, as the LM
    stages run it (full f32)."""
    from tpudl_torch.device import full_f32

    with full_f32():
        return net.generate(np.asarray(prompt)[None, :], max_new,
                            **kw).cpu().numpy()[0]


def serve_drain(eng, probes):
    """Insert ``probes`` into ``eng`` and step until all complete; their
    token streams in order."""
    for p in probes:
        eng.insert(p)
    done = {}
    while len(done) < len(probes):
        eng.step()
        for req, toks in eng.pop_completed():
            done[id(req)] = toks
    return [done[id(p)] for p in probes]


def serve_step_twin(eng):
    """A copy of the engine's step state and the eager step program over
    it: the same step the graph replays, run op by op."""
    twin = ([{kv: c[kv].clone() for kv in c} for c in eng._cache],
            eng._tok.clone(), eng._pos.clone(), eng._steps.clone(),
            eng._live.clone(), eng._logits.clone())
    return twin, eng.model._slot_step_program(eng.temperature)


def serve_parity_leg(entry, weights, card, problems):
    """8 greedy requests of ragged prompts through the slots against the
    serial ``generate`` on the card (and 2 against the CPU port), with one
    step's graph replay against the eager step on the same state."""
    from tpudl_torch.device import full_f32
    from tpudl_torch.zoo.transformer import TinyCausalLM

    eng, net = entry.engine, entry.engine.model
    prompts = serve_prompts(SERVE_PARITY_PLENS, SEED)
    probes = [_Probe(p, SERVE_MAX_NEW) for p in prompts]
    for p in probes:
        eng.insert(p)
    with torch.inference_mode(), full_f32():
        twin, eager = serve_step_twin(eng)
        eager(*twin)
    eng.step()
    torch.cuda.synchronize()
    with torch.inference_mode():
        want = twin[5]
        err = float((eng._logits - want).abs().max())
        scale = float(want.abs().max())
    print(f"  one slot step, graph replay vs the eager step on the same "
          f"state: max |dlogit| {err:.3e} ({err / scale:.3e} of max |logit| "
          f"{scale:.3e}; tolerance {SERVE_LOGIT_RTOL}; the same kernels, so "
          f"0 expected); card {card}")
    if not err <= SERVE_LOGIT_RTOL * scale:
        problems.append(f"slot step replay vs eager {err:.3e}")
    done = {}
    while len(done) < len(probes):
        for req, toks in eng.pop_completed():
            done[id(req)] = toks
        if len(done) < len(probes):
            eng.step()
    slots = [done[id(p)] for p in probes]
    t0 = time.perf_counter()
    serial = [serve_serial(net, p, SERVE_MAX_NEW) for p in prompts]
    t_serial = time.perf_counter() - t0
    equal = [bool(np.array_equal(a, b)) for a, b in zip(slots, serial)]
    print(f"  parity: {len(prompts)} greedy requests, prompts "
          f"{list(SERVE_PARITY_PLENS)}, max_new {SERVE_MAX_NEW}: slot streams "
          f"equal to the serial generate on the card: {equal} (serial "
          f"{t_serial:.2f} s)")
    if not all(equal):
        problems.append(f"slot streams differ from serial generate: {equal}")
    cpu = TinyCausalLM.from_jax_params(
        weights, vocab=VOCAB, dim=DIM, heads=HEADS, layers=LAYERS,
        max_len=MAX_LEN, device="cpu")
    cpu_equal = [bool(np.array_equal(
        serve_serial(cpu, p, SERVE_MAX_NEW), s))
        for p, s in zip(prompts[:SERVE_CPU_PROMPTS], slots)]
    print(f"  parity: the first {SERVE_CPU_PROMPTS} slot streams equal to the "
          f"CPU port's generate: {cpu_equal}")
    if not all(cpu_equal):
        problems.append(f"slot streams differ from the CPU: {cpu_equal}")
    del cpu


def serve_churn_leg(reg, entry, warm_captures, card, problems):
    """24 requests over 6 prompt lengths through the 8 slots (3 cycles of
    insert, complete and reuse) through the server, an explicit mid-decode
    eviction, and a sampled engine against ``generate(generator=)``; no
    graph captured after warm-up."""
    from tpudl_torch.serve import ModelRegistry, RequestQueue, Server

    eng, net = entry.engine, entry.engine.model
    srv = Server(reg, RequestQueue(cap=64))
    prompts = serve_prompts(SERVE_CHURN_PLENS * SERVE_CHURN_REPEATS, SEED + 1)
    reqs = [srv.submit(p, SERVE_MAX_NEW, model="lm") for p in prompts]
    srv._stop.set()
    t0 = time.perf_counter()
    summary = srv.run()
    t_run = time.perf_counter() - t0
    got = [r.result(timeout=SERVE_TIMEOUT) for r in reqs]
    equal = sum(bool(np.array_equal(g, serve_serial(net, p, SERVE_MAX_NEW)))
                for g, p in zip(got, prompts))
    print(f"  churn: {len(reqs)} requests of {len(SERVE_CHURN_PLENS)} prompt "
          f"lengths through {eng.slots} slots in {summary['ticks']} ticks, "
          f"{t_run:.2f} s; {equal}/{len(reqs)} streams equal to serial "
          f"generate")
    if equal != len(reqs):
        problems.append(f"churn: {len(reqs) - equal} streams differ")
    # an explicit eviction mid-decode, its slot reused at once
    a, b, c, d = [_Probe(p, SERVE_MAX_NEW)
                  for p in serve_prompts((20, 30, 40, 50), SEED + 2)]
    for p in (a, b, c):
        eng.insert(p)
    for _ in range(4):
        eng.step()
    slot_b = next(s for s, r in eng.occupants() if r is b)
    eng.evict(slot_b)
    reused = eng.insert(d)
    done = {}
    while len(done) < 3:
        eng.step()
        for req, toks in eng.pop_completed():
            done[id(req)] = toks
    kept = [bool(np.array_equal(done[id(p)], serve_serial(
        net, p.prompt[0], SERVE_MAX_NEW))) for p in (a, c, d)]
    print(f"  eviction: slot {slot_b} evicted after 4 steps and reused "
          f"(slot {reused}); its neighbours and the new occupant equal "
          f"serial generate: {kept}")
    if not all(kept) or reused != slot_b:
        problems.append(f"eviction leg: {kept}, slot {reused} vs {slot_b}")
    # a sampled engine over the same module, in a registry of its own (the
    # load leg's occupancy counts the greedy engine's slots alone)
    sreg = ModelRegistry()
    sampled = sreg.add_model("lm_sampled", net, slots=2,
                             cache_len=SERVE_CACHE,
                             temperature=SERVE_TEMPERATURE)
    seng = sampled.engine
    s_warm = seng.captures
    prompt = serve_prompts((40,), SEED + 3)[0]
    srv = Server(sreg, RequestQueue(cap=8))
    req = srv.submit(prompt, SERVE_MAX_NEW, model="lm_sampled",
                     rng=SERVE_SAMPLE_SEED)
    peer = srv.submit(prompt, SERVE_MAX_NEW, model="lm_sampled",
                      rng=SERVE_SAMPLE_SEED + 1)
    srv._stop.set()
    srv.run()
    gen = torch.Generator(device=net.device)
    gen.manual_seed(SERVE_SAMPLE_SEED)
    want = serve_serial(net, prompt, SERVE_MAX_NEW,
                        temperature=SERVE_TEMPERATURE, generator=gen)
    got = req.result(timeout=SERVE_TIMEOUT)
    other = peer.result(timeout=SERVE_TIMEOUT)
    print(f"  sampled (temperature {SERVE_TEMPERATURE}, rng "
          f"{SERVE_SAMPLE_SEED}): stream equal to generate(generator=): "
          f"{bool(np.array_equal(got, want))}; its neighbour (rng "
          f"{SERVE_SAMPLE_SEED + 1}) differs: "
          f"{not np.array_equal(got, other)}")
    if not np.array_equal(got, want):
        problems.append("sampled slot differs from generate(generator=)")
    new = eng.captures - warm_captures
    print(f"  graphs: {warm_captures} captured at registration; {new} "
          f"captured since, through parity and churn (want 0); the sampled "
          f"engine's {s_warm} at its registration, {seng.captures - s_warm} "
          f"after")
    if new or seng.captures != s_warm:
        problems.append(f"{new} graphs captured after warm-up")


def serve_load_leg(reg, entry, card, problems):
    """``run_closed_loop`` against the threaded server over ragged prompts,
    beside the serial eager ``generate`` over every 4th of the same
   prompts, the time of one 256-token insert, one step's
    replay against the eager step, a profile of steady decode steps, and
    the slot decode's flash launches. Returns the launch counts."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.device import full_f32
    from tpudl_torch.obs import metrics
    from tpudl_torch.serve import RequestQueue, Server, run_closed_loop

    eng, net = entry.engine, entry.engine.model
    rng = np.random.default_rng(SEED + 4)
    lengths = rng.integers(SERVE_LOAD_PLEN[0], SERVE_LOAD_PLEN[1] + 1,
                           size=SERVE_LOAD_REQUESTS)
    prompts = serve_prompts(lengths, SEED + 5)
    reset_launch_counts()
    srv = Server(reg, RequestQueue(cap=SERVE_LOAD_REQUESTS)).start_async()
    try:
        out = run_closed_loop(srv, lambda i: prompts[i],
                              requests=SERVE_LOAD_REQUESTS,
                              clients=SERVE_CLIENTS, max_new=SERVE_MAX_NEW,
                              model="lm", timeout=SERVE_TIMEOUT)
    finally:
        summary = srv.close(timeout=SERVE_TIMEOUT)
    torch.cuda.synchronize()
    counts = dict(cuda_ops.launch_counts)
    tok_s = metrics.gauge("serve.tokens_per_s").value
    occ = metrics.gauge("serve.batch_occupancy").value
    serial = prompts[::SERVE_SERIAL_EVERY]
    t0 = time.perf_counter()
    n_serial = 0
    for p in serial:
        n_serial += len(serve_serial(net, p, SERVE_MAX_NEW))
    t_serial = time.perf_counter() - t0
    print(f"  closed loop: {SERVE_LOAD_REQUESTS} requests, {SERVE_CLIENTS} "
          f"clients, prompts {SERVE_LOAD_PLEN[0]}-{SERVE_LOAD_PLEN[1]} tokens "
          f"(mean {lengths.mean():.1f}), max_new {SERVE_MAX_NEW}: "
          f"{json.dumps(out)}; session {summary['ticks']} ticks, "
          f"{summary['wall_s']} s; card {card}")
    print(f"  serving: {out['qps']} qps, p50 {out['p50_ms']} ms, p99 "
          f"{out['p99_ms']} ms, TTFT p50 {out['ttft_p50_s']} s, p99 "
          f"{out['ttft_p99_s']} s, "
          f"{out['completed'] * SERVE_MAX_NEW / out['wall_s']:.1f} tokens/s "
          f"end to end (serve.tokens_per_s {tok_s:.1f}: the loop's decode "
          f"steps over its session), slot occupancy {occ:.3f}; "
          f"serial eager generate over {len(serial)} of the same prompts "
          f"(every {SERVE_SERIAL_EVERY}th, mean "
          f"{np.mean([len(p) for p in serial]):.1f} tokens): "
          f"{n_serial / t_serial:.1f} tokens/s ({t_serial:.2f} s, "
          f"{len(serial) / t_serial:.3f} requests/s); card {card}")
    if out["completed"] != SERVE_LOAD_REQUESTS or out["rejected"]:
        problems.append(f"closed loop completed {out['completed']}, "
                        f"rejected {out['rejected']}")
    print(f"  flash kernel launches in the slot decode: {counts} (want 0)")
    if any(counts.values()):
        problems.append(f"the slot decode launched {counts}")
    # one insert of the longest load prompt, then one step with every
    # slot live: graph replay vs the eager step
    probes = [_Probe(p, SERVE_CACHE - 400) for p in
              serve_prompts([SERVE_LOAD_PLEN[1]] + [100] * (eng.slots - 1),
                            SEED + 6)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.insert(probes[0])
    insert_ms = (time.perf_counter() - t0) * 1e3
    print(f"  one insert of a {SERVE_LOAD_PLEN[1]}-token prompt (first token "
          f"on the host): {insert_ms:.2f} ms, "
          f"{insert_ms / SERVE_LOAD_PLEN[1]:.3f} ms a prompt token; card "
          f"{card}")
    for p in probes[1:]:
        eng.insert(p)
    with torch.inference_mode(), full_f32():
        twin, eager = serve_step_twin(eng)
        eager_ms = cuda_ms(lambda: eager(*twin), reps=20)
        prog = eng._program("step")
        replay_ms = cuda_ms(prog, reps=20)
    print(f"  one decode step of {eng.slots} live slots at cache "
          f"{SERVE_CACHE}: graph replay {replay_ms:.4f} ms, the same step "
          f"eager {eager_ms:.4f} ms ({eager_ms / replay_ms:.2f}x); card "
          f"{card}")
    wall, busy, n_events = idle_profile(lambda: [eng.step()
                                                 for _ in range(10)])
    print(idle_text("10 steady decode steps (replay + next tokens to "
                    "host)", wall, busy, n_events, card).replace(
                        "one transform", "10 steps"))
    with torch.inference_mode(), full_f32():
        profile_train_step("one eager decode step (the kernels the graph "
                           "replays)", lambda: eager(*twin), card,
                           SERVE_OP_GROUPS)
    eng.evict_all()
    return counts


def serve_admission_leg(reg, entry, card, problems):
    """A typed queue_full reject, a typed slots_full on a direct insert,
    and a deadline shed mid-decode; every wait bounded."""
    from tpudl_torch.obs import metrics
    from tpudl_torch.serve import (AdmissionError, DeadlineExceeded,
                                   RequestQueue, Server)

    eng, net = entry.engine, entry.engine.model
    prompt = serve_prompts((16,), SEED + 7)[0]
    srv = Server(reg, RequestQueue(cap=2))
    srv.submit(prompt, 4, model="lm")
    srv.submit(prompt, 4, model="lm")
    t0 = time.perf_counter()
    try:
        srv.submit(prompt, 4, model="lm")
        reason = None
    except AdmissionError as e:
        reason = e.reason
    t_reject = (time.perf_counter() - t0) * 1e3
    srv.queue.fail_all(RuntimeError("drained by the smoke test"))
    for _ in range(eng.slots):
        eng.insert(_Probe(prompt, 4))
    try:
        eng.insert(_Probe(prompt, 4))
        slots_reason = None
    except AdmissionError as e:
        slots_reason = e.reason
    eng.evict_all()
    sheds = metrics.counter("serve.deadline_sheds").value
    srv = Server(reg, RequestQueue(cap=8)).start_async()
    try:
        doomed = srv.submit(prompt, SERVE_CACHE - 64, model="lm",
                            deadline_s=SERVE_DEADLINE_S)
        peer = srv.submit(prompt, SERVE_MAX_NEW, model="lm")
        try:
            doomed.result(timeout=SERVE_TIMEOUT)
            shed = None
        except DeadlineExceeded as e:
            shed = str(e)
        peer_ok = bool(np.array_equal(peer.result(timeout=SERVE_TIMEOUT),
                                      serve_serial(net, prompt,
                                                   SERVE_MAX_NEW)))
    finally:
        srv.close(timeout=SERVE_TIMEOUT)
    sheds = metrics.counter("serve.deadline_sheds").value - sheds
    print(f"  admission: a 3rd submit to a cap-2 queue: {reason!r} in "
          f"{t_reject:.3f} ms; a 9th insert into {eng.slots} slots: "
          f"{slots_reason!r}; a {SERVE_DEADLINE_S} s deadline on "
          f"{SERVE_CACHE - 64} new "
          f"tokens: DeadlineExceeded {shed!r} ({sheds:.0f} shed), its peer "
          f"equal to serial generate: {peer_ok}")
    if reason != "queue_full" or slots_reason != "slots_full":
        problems.append(f"admission rejects {reason!r}, {slots_reason!r}")
    if shed is None or "mid-decode" not in shed or sheds != 1 or not peer_ok:
        problems.append(f"deadline shed {shed!r}, {sheds} sheds, peer "
                        f"{peer_ok}")


def serve_batcher_leg(weights, card, problems):
    """``RungBatcher`` over the LM embed function (``LMFeaturizer``'s
    per-batch function) with ragged payloads: one padded dispatch, 12
    flash forward launches, the split rows against ``LMFeaturizer`` on
    the same texts, on the card (the same kernel: padding and splitting)
    and on the CPU (the plain attention). Returns the launch counts of the
    timed dispatches."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.device import full_f32
    from tpudl_torch.frame import Frame
    from tpudl_torch.ml import LMFeaturizer
    from tpudl_torch.obs import metrics
    from tpudl_torch.serve import RungBatcher
    from tpudl_torch.text import ByteTokenizer, pad_mask, tokenize_pack
    from tpudl_torch.zoo.transformer import TinyCausalLM

    tok = ByteTokenizer()
    rng = np.random.default_rng(SEED + 8)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     ,.",
                            dtype=np.uint8)
    texts = np.array([rng.choice(letters, size=SERVE_BATCHER_BYTES).tobytes()
                      .decode() for _ in range(sum(SERVE_BATCHER_ROWS))],
                     dtype=object)
    rows = tokenize_pack(tok, bos=True)(texts)
    cuts = np.cumsum(SERVE_BATCHER_ROWS)[:-1]
    payloads = np.split(rows, cuts)
    spec = TinyCausalLM(VOCAB, DIM, HEADS, LAYERS, MAX_LEN, device="meta")
    net = TinyCausalLM.from_jax_params(
        weights, vocab=VOCAB, dim=DIM, heads=HEADS, layers=LAYERS,
        max_len=MAX_LEN, device="cuda")

    def embed(tokens):
        with torch.inference_mode(), full_f32():
            t = torch.from_numpy(tokens).to(net.device)
            mask = pad_mask(t)
            h = net.hidden(t)
            pooled = (h * mask[..., None]).sum(dim=1)
            return pooled / mask.sum(dim=1, keepdim=True).clamp_min(1.0)

    batcher = RungBatcher(embed)
    batcher.run(payloads)                     # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        outs = batcher.run(payloads)
    ms = (time.perf_counter() - t0) * 1e3 / reps
    counts = dict(cuda_ops.launch_counts)
    occ = metrics.gauge("serve.batch_occupancy").value
    def featurizer(device):
        return np.stack(list(LMFeaturizer(
            inputCol="text", outputCol="v", model=spec, weights=weights,
            tokenizer=tok, batchSize=len(texts), device=device).transform(
            Frame({"text": texts}))["v"]))

    got = np.concatenate(outs)
    n = len(texts)
    # the same kernel on the card, unpadded: padding to the rung and the
    # split are exact up to the GEMMs' other M
    card_feat = featurizer("cuda")
    err = float(np.abs(got - card_feat).max())
    scale = float(np.abs(card_feat).max())
    # the plain attention on the CPU: the batch through the kernel at the
    # shape this path gives it, against its plain version (phase 4's limit)
    cpu_err = float(np.abs(got - featurizer("cpu")).max())
    print(f"  RungBatcher over the LM embed function: payloads "
          f"{list(SERVE_BATCHER_ROWS)} rows x {rows.shape[1]} tokens -> one "
          f"dispatch of {batcher.rung_for(n)} rows, {ms:.2f} ms "
          f"({n / ms * 1e3:.1f} rows/s); flash launches over {reps} "
          f"dispatches {counts} (want {LAYERS * reps} forward); "
          f"serve.batch_occupancy {occ:.4f}; card {card}")
    print(f"  the batcher's {n} rows against LMFeaturizer on the card "
          f"(unpadded): max abs {err:.3e} ({err / scale:.3e} of max |y| "
          f"{scale:.3e}; tolerance {FEATURE_ATOL} of max |y|); against "
          f"LMFeaturizer on the CPU (plain attention): max abs "
          f"{cpu_err:.3e} (tolerance {FEATURE_ATOL}); card {card}")
    if counts["flash_attn_fwd"] != LAYERS * reps or \
            counts["flash_attn_bwd_dq"] or counts["flash_attn_bwd_dkv"]:
        problems.append(f"the batcher's dispatches launched {counts}")
    if [len(o) for o in outs] != list(SERVE_BATCHER_ROWS):
        problems.append(f"the batcher split {[len(o) for o in outs]}")
    if (batcher.rung_for(n), rows.shape[1], HEADS, DIM // HEADS) != \
            SERVE_BATCHER_SHAPE:
        problems.append(f"the batcher's blocks ran at another shape than "
                        f"phase 3's {SERVE_BATCHER_SHAPE}")
    if not err <= FEATURE_ATOL * scale:
        problems.append(f"batcher vs LMFeaturizer on the card {err:.3e}")
    if not cpu_err <= FEATURE_ATOL:
        problems.append(f"batcher vs LMFeaturizer on the CPU {cpu_err:.3e}")
    return counts


def run_serve(card):
    """Phase 15: serving at phase 4's width. Every check runs and prints;
    the phase fails at its end if any did not hold. Returns the kernel
    launches of its paths."""
    from tpudl_torch.serve import ModelRegistry
    from tpudl_torch.zoo.transformer import TinyCausalLM

    t_phase = time.perf_counter()
    problems = []
    spec = TinyCausalLM(VOCAB, DIM, HEADS, LAYERS, MAX_LEN, device="meta")
    weights = spec.init(SEED)
    reg = ModelRegistry()
    t0 = time.perf_counter()
    entry = reg.add_model("lm", spec, weights, slots=SERVE_SLOTS,
                          cache_len=SERVE_CACHE, warm=True)
    eng = entry.engine
    cache_bytes = sum(c[kv].numel() * c[kv].element_size()
                      for c in eng._cache for kv in c)
    print(f"  registration: {time.perf_counter() - t0:.2f} s (weights to the "
          f"card and warm-up); warm_signatures {entry.warm_signatures} "
          f"(the step, prefill and insert graphs), warm_s "
          f"{entry.warm_s:.3f} s; slot cache {SERVE_SLOTS} x {SERVE_CACHE} "
          f"x {LAYERS} layers: {cache_bytes / 1e9:.3f} GB f32; card {card}",
          flush=True)
    warm_captures = eng.captures      # 3 on the card; 0 on the CPU
    if entry.warm_signatures != 3:
        problems.append(f"warm-up made {entry.warm_signatures} programs")
    legs = (("serve_parity_leg", lambda: serve_parity_leg(
                entry, weights, card, problems)),
            ("serve_churn_leg", lambda: serve_churn_leg(
                reg, entry, warm_captures, card, problems)),
            ("serve_load_leg", lambda: serve_load_leg(
                reg, entry, card, problems)),
            ("serve_admission_leg", lambda: serve_admission_leg(
                reg, entry, card, problems)),
            ("serve_batcher_leg", lambda: serve_batcher_leg(
                weights, card, problems)))
    counts = {}
    for name, leg in legs:
        t0 = time.perf_counter()
        out = leg()
        if out is not None:
            counts[name] = out
        print(f"  {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    if eng.captures != warm_captures:
        problems.append(f"{eng.captures - warm_captures} graphs captured "
                        "after warm-up")
    print(f"  phase 15: {time.perf_counter() - t_phase:.1f} s; graphs "
          f"captured {eng.captures} (all at registration); card {card}")
    if problems:
        fail("phase 15: " + "; ".join(problems))
    return {"serve_slot_decode": counts["serve_load_leg"],
            "serve_rung_batcher": counts["serve_batcher_leg"]}



# phase 16: LM parallelism on a local mesh (tpudl_torch.attention,
# tpudl_torch.pipeline, TinyCausalLM(mesh=, tp=True), experts)
PAR_DEVICE = "cuda:0"              # the card of the one-card meshes
RING_SHAPE = (1, 32768, 16, 64)    # [B, S, H, D], causal, over 4 entries
RING_ENTRIES = 4
RING_PLAIN_SEQ = 8192              # the plain ring: 2048² f32 hop scores
RING_REPS = 3
# ring vs one flash call on the whole sequence: f32 as phase 3 holds the
# forward (2e-5), relative to max |O|; bf16 rounds each hop's O to bf16
# before the f32 merge, so 1e-2 of max |O| (~2.5 bf16 ulps)
RING_O_RTOL = {"float32": 2e-5, "bfloat16": 1e-2}
RING_LM_SEQ = 16384
LC_ARCH = dict(TRAIN_ARCH, max_len=8192)   # README's long-context recipe
LC_SEQ = 8193                      # 8192 tokens in, 8192 targets
LC_STEPS = 3                       # timed, after one warm-up step
LC_F64_SEQ = 1025                  # the float64 gradient check's row
LC_GRAD_RTOL = 1e-2                # of the largest float64 gradient
PAR_LOGIT_RTOL = 1e-4              # of max |logit| (or |feature|)
PAR_LOSS_ATOL = 2e-5
TP_TOKENS = (4, 1024)
TP_PROMPT, TP_NEW = 64, 32         # greedy generate: 4 prompts
TP_SLOT_PLENS = (5, 9, 17, 33, 40, 50, 64, 100)
TP_SLOT_CACHE = 256
TP_FEATURE_ROWS, TP_FEATURE_BATCH = 16, 8
TP_STEP_TOKENS = (2, 513)
MOE_EXPERTS = 8
MOE_TOKENS = (2, 1024)
PP_STAGES, PP_MICRO = 4, 8
PP_TOKENS = (16, 1024)
PP_STEP_TOKENS = (16, 257)
# phase 16's local-mesh figures, which phase 18 prints beside its own
LOCAL_FIGURES: dict = {}


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def wall_ms(fn, reps=RING_REPS) -> float:
    """Host wall time of one ``fn()`` (the mean of ``reps``), every card
    synchronised at both ends: a mesh's work spans cards, which one
    card's events cannot time."""
    sync_all()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync_all()
    return (time.perf_counter() - t0) * 1e3 / reps


def card_idle(fn):
    """(wall ms, {card: busy ms}) of one ``fn()`` under torch.profiler,
    tracing the cards alone: each card's busy time sums the kernels and
    copies it ran, through a marked capture."""
    from tpudl_torch.obs import trace as T

    def run():
        sync_all()
        t0 = time.perf_counter()
        fn()
        sync_all()
        return (time.perf_counter() - t0) * 1e3

    prof, wall = card_capture(run, cpu=False)
    busy: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                T.MARK_KERNEL not in e.name:
            busy[e.device_index] = (busy.get(e.device_index, 0.0)
                                    + e.self_device_time_total / 1e3)
    return wall, busy


def host_profile(what, fn, top=8):
    """Where one ``fn()`` spends the host's time: the ops with the most
    self CPU time under torch.profiler (CPU activity only), beside the
    run's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sync_all()
        t0 = time.perf_counter()
        fn()
        sync_all()
        wall = (time.perf_counter() - t0) * 1e3
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    print(f"  {what}: host profile, wall {wall:.1f} ms; the ops with the "
          "most self CPU time:")
    for e in ops[:top]:
        print(f"    {e.self_cpu_time_total / 1e3:8.2f} ms x{e.count:<5d} "
              f"{e.key[:80]}")


def idle_line(what, wall, busy, card) -> str:
    if not busy:
        return f"  {what}: card idle share not measured (no device events)"
    shares = ", ".join(f"cuda:{d} {100 * (1 - b / wall):.1f}% idle "
                       f"({b:.1f} ms busy)" for d, b in sorted(busy.items()))
    return f"  {what}: wall {wall:.1f} ms; {shares}; card {card}"


def parallel_cases(n_entries, tp=False):
    """The meshes of a phase-16 leg: ``(label, mesh)``. ``n_entries``
    entries of one card always, and, where two or more cards are visible,
    one entry a card; on the data axis (``(n, 1)``), or under ``tp`` on
    the model axis (``(1, n)``)."""
    from tpudl_torch import mesh as M

    def grid(n, devices):
        return M.build_mesh(*((1, n) if tp else (n, 1)), devices=devices)

    cases = [(f"{n_entries} entries of one card",
              grid(n_entries, [PAR_DEVICE] * n_entries))]
    n = torch.cuda.device_count()
    if n > 1:
        cases.append((f"{n} cards", grid(n, [f"cuda:{i}"
                                             for i in range(n)])))
    return cases


def grad_err(got, want):
    """max |got - want| over tensors, and the largest |want|."""
    err = max((g.float() - w.float()).abs().max().item()
              for g, w in zip(got, want))
    return err, max(w.float().abs().max().item() for w in want)


def ring_kernel_leg(card, problems):
    """The ring over the flash kernels at ``RING_SHAPE``: forward and
    gradients against one flash call on the whole sequence, launches a
    call, times; then the plain ring. Returns the f32 ring call's
    launches."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.attention import ring_attention

    gen = torch.Generator().manual_seed(SEED + 16)
    counts = None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        q, k, v, do = ((torch.randn(*RING_SHAPE, generator=gen))
                       .to(PAR_DEVICE, dtype) for _ in range(4))
        one = lambda *t: cuda_ops.flash_attention(*t, causal=True)  # noqa
        with torch.no_grad():
            want = one(q, k, v)
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        one(qg, kg, vg).backward(do)
        want_g = tuple(t.grad.clone() for t in (qg, kg, vg))
        one_ms = wall_ms(lambda: one(q, k, v))
        one_bwd_ms = wall_ms(lambda: one(qg, kg, vg).backward(do))
        for label, mesh in parallel_cases(RING_ENTRIES):
            n = mesh.size

            def ring(*t):
                return ring_attention(*t, mesh, causal=True, use_pallas=True)

            reset_launch_counts()
            with torch.no_grad():
                got = ring(q, k, v)
            sync_all()
            fwd = dict(cuda_ops.launch_counts)
            for t in (qg, kg, vg):
                t.grad = None
            reset_launch_counts()
            ring(qg, kg, vg).backward(do)
            sync_all()
            train = dict(cuda_ops.launch_counts)
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            g_err, g_scale = grad_err((qg.grad, kg.grad, vg.grad), want_g)
            tol = GRAD_TOL[name]
            g_lim = (tol["abs"] + tol["rel"]) * g_scale
            ms = wall_ms(lambda: ring(q, k, v))
            bwd_ms = wall_ms(lambda: ring(qg, kg, vg).backward(do))
            tri = n * (n + 1) // 2
            ok = (err <= RING_O_RTOL[name] * scale and g_err <= g_lim
                  and fwd["flash_attn_fwd"] == tri
                  and train == {"flash_attn_fwd": tri,
                                "flash_attn_bwd_dq": tri,
                                "flash_attn_bwd_dkv": tri})
            print(f"  ring {name} {label}: O max abs {err:.3e} (limit "
                  f"{RING_O_RTOL[name]:g} x max |O| {scale:.3f}), grads max "
                  f"abs {g_err:.3e} (limit {g_lim:.3e} = "
                  f"{tol['abs'] + tol['rel']:.3g} x max |grad| "
                  f"{g_scale:.3f}); launches a call: forward {fwd}, "
                  f"training {train} (want {tri} each); forward {ms:.2f} ms"
                  f" (one flash call {one_ms:.2f} ms), forward+backward "
                  f"{bwd_ms:.2f} ms (one call {one_bwd_ms:.2f} ms); "
                  f"{'ok' if ok else 'MISS'}; card {card}", flush=True)
            if not ok:
                problems.append(f"ring {name} {label}")
            if dtype == torch.float32 and counts is None:
                counts = train
        del q, k, v, do, qg, kg, vg, want, want_g
    # the plain ring: online softmax in f32 over hop scores
    q, k, v = (torch.randn(1, RING_PLAIN_SEQ, *RING_SHAPE[2:], generator=gen)
               .to(PAR_DEVICE) for _ in range(3))
    with torch.no_grad():
        want = cuda_ops.flash_attention(q, k, v, causal=True)
        for label, mesh in parallel_cases(RING_ENTRIES):
            reset_launch_counts()
            got = ring_attention(q, k, v, mesh, causal=True)
            sync_all()
            launched = sum(cuda_ops.launch_counts.values())
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            ms = wall_ms(lambda: ring_attention(q, k, v, mesh, causal=True))
            ok = err <= RING_O_RTOL["float32"] * scale and launched == 0
            print(f"  plain ring float32 {label} [1, {RING_PLAIN_SEQ}, 16, "
                  f"64]: O max abs {err:.3e} (limit 2e-5 x {scale:.3f}), "
                  f"{launched} kernel launches (want 0), {ms:.2f} ms; "
                  f"{'ok' if ok else 'MISS'}; card {card}", flush=True)
            if not ok:
                problems.append(f"plain ring {label}")
    return counts


def ring_lm_leg(card, problems):
    """``TinyCausalLM(32000, 1024, 16, 12, max_len=16384)`` over the ring
    on one ``[1, 16384]`` row against ``apply`` without a mesh. Returns
    the 4-entry forward's launches."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.zoo.transformer import TinyCausalLM, arch_of

    spec = TinyCausalLM(VOCAB, DIM, HEADS, LAYERS, RING_LM_SEQ,
                        device="meta")
    net = TinyCausalLM.from_jax_params(spec.init(SEED), **arch_of(spec),
                                       device=PAR_DEVICE)
    toks = torch.from_numpy(np.random.default_rng(SEED + 16).integers(
        0, VOCAB, size=(1, RING_LM_SEQ))).to(PAR_DEVICE)
    counts = None
    with torch.no_grad():
        want = net.apply(toks)
        one_ms = wall_ms(lambda: net.apply(toks), reps=1)
        scale = want.abs().max().item()
        for label, mesh in parallel_cases(RING_ENTRIES):
            reset_launch_counts()
            got = net.apply(toks, mesh=mesh, use_pallas=True)
            sync_all()
            launched = dict(cuda_ops.launch_counts)
            err = (got - want).abs().max().item()
            del got
            ms = wall_ms(lambda: net.apply(toks, mesh=mesh), reps=1)
            wall, busy = card_idle(lambda: net.apply(toks, mesh=mesh))
            n = mesh.size
            ok = (err <= PAR_LOGIT_RTOL * scale
                  and launched["flash_attn_fwd"] == LAYERS * n * (n + 1) // 2)
            print(f"  LM over the ring {label} [1, {RING_LM_SEQ}]: logits "
                  f"max abs {err:.3e} (limit 1e-4 x {scale:.3f}), launches "
                  f"{launched} (want {LAYERS * n * (n + 1) // 2} forward), "
                  f"{ms:.1f} ms (no mesh {one_ms:.1f} ms); "
                  f"{'ok' if ok else 'MISS'}", flush=True)
            print(idle_line(f"LM over the ring {label}, idle share", wall,
                            busy, card))
            if not ok:
                problems.append(f"LM over the ring {label}")
            if counts is None:
                counts = launched
    return counts


def lm_loss_f64(params, tokens, heads):
    """The LM's next-token loss in float64, dense attention, plain torch:
    the yardstick of the long-context gradients."""
    import torch.nn.functional as F

    def norm(x, g, b):
        return F.layer_norm(x, (x.shape[-1],), g, b, eps=1e-5)

    x = F.embedding(tokens[:, :-1], params["embed"]["table"])
    b, s, d = x.shape
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    for i in range(len(params) - 2):
        p = params[f"block_{i}"]
        h = norm(x, p["norm1_gamma"], p["norm1_beta"])
        q, k, v = ((h @ p[w]).view(b, s, heads, d // heads)
                   for w in ("wq", "wk", "wv"))
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / (d // heads) ** 0.5
        w = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
        x = x + torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, s, d) \
            @ p["wo"]
        h = norm(x, p["norm2_gamma"], p["norm2_beta"])
        x = x + F.gelu(h @ p["w_up"] + p["b_up"], approximate="tanh") \
            @ p["w_down"] + p["b_down"]
    x = norm(x, params["final_norm"]["gamma"], params["final_norm"]["beta"])
    logits = x @ params["embed"]["table"].T
    return F.cross_entropy(logits.flatten(0, 1),
                           tokens[:, 1:].flatten().long())


def long_context_leg(card, problems):
    """README's long-context recipe: ``Trainer(lm.loss_fn(mesh=mesh,
    use_pallas=True), adamw(3e-4), mesh=mesh)`` on one row of 8192
    tokens; the first loss against the one-card loss, the first step's
    gradients (at 1024 tokens) against float64, launches a step, rates.
    Returns the 4-entry mesh's launches of one step."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.device import full_f32
    from tpudl_torch.train import Trainer, adamw
    from tpudl_torch.zoo.transformer import (TinyCausalLM, _leaf_groups,
                                             _param_groups)

    spec = TinyCausalLM(**LC_ARCH, device="meta")
    weights = spec.init(SEED)
    rng = np.random.default_rng(SEED + 17)
    rows = rng.integers(0, LC_ARCH["vocab"], size=(1, LC_SEQ)).astype(
        np.int32)
    short = torch.from_numpy(rows[:, :LC_F64_SEQ]).to(PAR_DEVICE)
    counts = None
    for label, mesh in parallel_cases(RING_ENTRIES):
        net = TinyCausalLM.from_jax_params(weights, **LC_ARCH,
                                           device=PAR_DEVICE)
        with torch.no_grad(), full_f32():
            one_loss = net.loss_fn()(net, torch.from_numpy(rows).to(
                PAR_DEVICE)).item()
        # the first step's gradients at LC_F64_SEQ tokens against float64
        with full_f32():
            net.loss_fn(mesh=mesh, use_pallas=True)(net, short).backward()
        got_g = {f"{g}.{k}": t.grad.detach().clone()
                 for g, grp in _param_groups(net).items()
                 for k, t in grp.items()}
        net.zero_grad(set_to_none=True)
        p64 = {g: {k: t.detach().double().requires_grad_()
                   for k, t in grp.items()}
               for g, grp in _leaf_groups(net).items()}
        lm_loss_f64(p64, short, LC_ARCH["heads"]).backward()
        want_g = {f"{g}.{k}": t.grad for g, grp in p64.items()
                  for k, t in grp.items()}
        g_scale = max(t.abs().max().item() for t in want_g.values())
        g_err = max((got_g[n].double() - want_g[n]).abs().max().item()
                    for n in want_g)
        del p64, want_g, got_g
        trainer = Trainer(net.loss_fn(mesh=mesh, use_pallas=True),
                          adamw(LR), mesh=mesh, log_every=1)
        data = lambda step: rows  # noqa: E731
        _, opt, hist = trainer.fit(net, data, 1)
        first = hist[0]["loss"]
        reset_launch_counts()
        sync_all()
        t0 = time.perf_counter()
        trainer.fit(net, data, LC_STEPS, opt_state=opt)
        sync_all()
        secs = time.perf_counter() - t0
        launched = dict(cuda_ops.launch_counts)
        wall, busy = card_idle(lambda: trainer.fit(net, data, 1,
                                                   opt_state=opt))
        n = mesh.size
        want_n = LC_ARCH["layers"] * n * (n + 1) // 2 * LC_STEPS
        ok = (abs(first - one_loss) <= PAR_LOSS_ATOL
              and g_err <= LC_GRAD_RTOL * g_scale
              and all(v == want_n for v in launched.values()))
        print(f"  long-context training {label} 1x{LC_SEQ - 1} tokens: first"
              f" loss {first:.6f}, one card {one_loss:.6f} (|diff| "
              f"{abs(first - one_loss):.2e}, limit {PAR_LOSS_ATOL:g}); "
              f"first-step gradients at 1x{LC_F64_SEQ - 1} tokens: max abs "
              f"{g_err:.3e} vs float64 (limit {LC_GRAD_RTOL:g} x "
              f"{g_scale:.3e}); {LC_STEPS} steps: launches {launched} "
              f"(want {want_n} each), {LC_STEPS / secs:.3f} steps/s, "
              f"{LC_STEPS * (LC_SEQ - 1) / secs:.0f} tokens/s; "
              f"{'ok' if ok else 'MISS'}; card {card}", flush=True)
        print(idle_line(f"long-context training {label}, one step's idle "
                        "share", wall, busy, card))
        LOCAL_FIGURES[f"long-context training {label}"] = (
            f"{LC_STEPS / secs:.3f} steps/s, one step idle "
            + ", ".join(f"cuda:{d} {100 * (1 - b / wall):.1f}%"
                        for d, b in sorted(busy.items())))
        host_profile(f"long-context training {label}, one step",
                     lambda: trainer.fit(net, data, 1, opt_state=opt))
        if not ok:
            problems.append(f"long-context training {label}")
        if counts is None:
            counts = {k: v // LC_STEPS for k, v in launched.items()}
        del net, trainer, opt
    return counts


def sgd_losses(net, loss_fn, batches, **step_kw):
    """The losses of ``len(batches)`` sgd steps of ``net`` (in place)."""
    from tpudl_torch.train import make_train_step, sgd

    step = make_train_step(loss_fn, **step_kw)
    if "param_shardings" in step_kw:
        net.shard_params(step_kw["mesh"])
    opt = sgd(0.1)(net.parameters())
    return [step(net, opt, b).item() for b in batches]


def tp_leg(card, problems):
    """Tensor parallelism at serving width over a ``(1, N)`` mesh: logits,
    greedy generate, 8 slot streams, the featurizer, each card's share of
    the split leaves and two ``param_shardings`` sgd steps. Returns the
    one-card mesh's launches of one ``apply(tp=True)``."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.frame import Frame
    from tpudl_torch.ml import LMFeaturizer
    from tpudl_torch.serve import ModelRegistry, ServeRequest
    from tpudl_torch.text import ByteTokenizer
    from tpudl_torch.zoo.transformer import TinyCausalLM, arch_of

    spec = TinyCausalLM(VOCAB, DIM, HEADS, LAYERS, MAX_LEN, device="meta")
    weights = spec.init(SEED)
    net = TinyCausalLM.from_jax_params(weights, **arch_of(spec),
                                       device=PAR_DEVICE)
    rng = np.random.default_rng(SEED + 18)
    toks = torch.from_numpy(rng.integers(0, VOCAB, size=TP_TOKENS)).to(
        PAR_DEVICE)
    prompts = torch.from_numpy(rng.integers(0, VOCAB, size=(4, TP_PROMPT)))
    slot_prompts = [rng.integers(0, VOCAB, size=n).astype(np.int32)
                    for n in TP_SLOT_PLENS]
    texts = make_texts(TP_FEATURE_ROWS, SEED + 18)
    step_rows = [torch.from_numpy(rng.integers(0, VOCAB, size=TP_STEP_TOKENS))
                 .to(PAR_DEVICE) for _ in range(2)]
    with torch.no_grad():
        want = net.apply(toks)
        one_ms = wall_ms(lambda: net.apply(toks), reps=1)
        want_gen = net.generate(prompts, TP_NEW).cpu()
        serial = [net.generate(p[None], TP_NEW)[0].cpu().tolist()
                  for p in slot_prompts]
    scale = want.abs().max().item()
    feat_kw = dict(inputCol="text", outputCol="v", model=spec,
                   weights=weights, tokenizer=ByteTokenizer(),
                   batchSize=TP_FEATURE_BATCH)
    want_feat = np.stack(list(LMFeaturizer(device=PAR_DEVICE, **feat_kw)
                              .transform(Frame({"text": texts}))["v"]))
    want_steps = sgd_losses(TinyCausalLM.from_jax_params(
        weights, **arch_of(spec), device=PAR_DEVICE), net.loss_fn(),
        step_rows)
    counts = None
    for label, mesh in parallel_cases(2, tp=True):
        n = mesh.shape["model"]
        lay = TinyCausalLM.from_jax_params(weights, **arch_of(spec),
                                           device=PAR_DEVICE)
        lay.shard_params(mesh)
        per_card = [sum(t.numel() * t.element_size()
                        for t in lay.tp_shards[j].parameters())
                    for j in range(n)]
        total = sum(t.nbytes for i in range(LAYERS)
                    for k, t in weights[f"block_{i}"].items()
                    if k in lay.tp_shards[0][0])
        with torch.no_grad():
            reset_launch_counts()
            got = lay.apply(toks, mesh=mesh, tp=True)
            sync_all()
            launched = dict(cuda_ops.launch_counts)
            err = (got - want).abs().max().item()
            del got
            ms = wall_ms(lambda: lay.apply(toks, mesh=mesh, tp=True), reps=1)
            gen = lay.generate(prompts, TP_NEW, mesh=mesh, tp=True).cpu()
        eng = ModelRegistry().add_model("lm", lay, slots=len(slot_prompts),
                                        cache_len=TP_SLOT_CACHE, mesh=mesh,
                                        tp=True).engine
        reqs = [ServeRequest(p, TP_NEW) for p in slot_prompts]
        for r in reqs:
            eng.insert(r)
        done = {}
        while eng.active():
            eng.step()
            done.update({id(r): t.tolist() for r, t in eng.pop_completed()})
        streams_ok = [done[id(r)] for r in reqs] == serial
        feat = np.stack(list(LMFeaturizer(mesh=mesh, tp=True,
                                          device=PAR_DEVICE, **feat_kw)
                             .transform(Frame({"text": texts}))["v"]))
        f_err = float(np.abs(feat - want_feat).max())
        f_lim = PAR_LOGIT_RTOL * float(np.abs(want_feat).max())
        shardings = lay.param_shardings(mesh)
        steps = sgd_losses(TinyCausalLM.from_jax_params(
            weights, **arch_of(spec), device=PAR_DEVICE),
            lay.loss_fn(mesh=mesh, tp=True), step_rows, mesh=mesh,
            param_shardings=shardings)
        s_err = max(abs(a - b) for a, b in zip(steps, want_steps))
        even = all(b * n == total for b in per_card)
        ok = (err <= PAR_LOGIT_RTOL * scale and torch.equal(gen, want_gen)
              and streams_ok and f_err <= f_lim and even
              and s_err <= PAR_LOSS_ATOL
              and launched["flash_attn_fwd"] == LAYERS * n)
        print(f"  TP {label} (1, {n}): apply(tp=True) {list(TP_TOKENS)} "
              f"logits max abs {err:.3e} (limit 1e-4 x {scale:.3f}), "
              f"launches {launched} (want {LAYERS * n} forward), {ms:.1f} "
              f"ms (unsplit {one_ms:.1f} ms); generate(tp=True) 4x{TP_NEW} "
              f"{'equal' if torch.equal(gen, want_gen) else 'DIFFERENT'}; "
              f"{len(reqs)} SlotDecoder(tp=True) streams "
              f"{'equal' if streams_ok else 'DIFFERENT'} to serial generate "
              f"({eng.captures} graphs); LMFeaturizer(mesh=, tp=True) "
              f"{TP_FEATURE_ROWS} rows max abs {f_err:.3e} (limit "
              f"{f_lim:.3e}); split leaves {per_card} bytes a card of "
              f"{total} ({'1/' + str(n) if even else 'NOT 1/N'});"
              f" 2 param_shardings sgd steps' losses {steps} vs {want_steps}"
              f" (max |diff| {s_err:.2e}, limit {PAR_LOSS_ATOL:g}); "
              f"{'ok' if ok else 'MISS'}; card {card}", flush=True)
        LOCAL_FIGURES[f"TP {label}"] = (f"apply(tp=True) {list(TP_TOKENS)} "
                                        f"{ms:.1f} ms (unsplit {one_ms:.1f})")
        if not ok:
            problems.append(f"TP {label}")
        if counts is None:
            counts = launched
        del lay, eng
    return counts


def card_moe_weights(model, seed):
    """Seeded weights for ``model``, drawn on its card (tpudl's ``init``
    scales: 1/√fan_in, the gate and embedding 0.02, norms 1 and 0, biases
    0) — the host draws of ``init`` would take seconds at this size."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            key = name.rsplit(".", 1)[-1]
            if "gamma" in key:
                p.fill_(1.0)
            elif key.startswith("b") or "beta" in key:
                p.zero_()
            else:
                fan_in = p.shape[-2] if p.dim() == 3 else p.shape[0]
                scale = 0.02 if key in ("table", "w_gate") else fan_in ** -0.5
                p.normal_(0.0, scale, generator=gen)


def moe_leg(card, problems):
    """``TinyCausalLM(32000, 1024, 16, 12, experts=8)``: ``apply(tp=True)``
    with the experts split over the model axis against the unsplit model,
    routing equal, the share of tokens dropped, and two sgd steps. Returns
    the one-card mesh's launches of one ``apply(tp=True)``."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.zoo.transformer import TinyCausalLM, to_jax_params

    arch = dict(vocab=VOCAB, dim=DIM, heads=HEADS, layers=LAYERS,
                max_len=MAX_LEN, experts=MOE_EXPERTS)
    net = TinyCausalLM(**arch, device=PAR_DEVICE)
    card_moe_weights(net, SEED)
    rng = np.random.default_rng(SEED + 19)
    toks = torch.from_numpy(rng.integers(0, VOCAB, size=MOE_TOKENS)).to(
        PAR_DEVICE)
    step_rows = [torch.from_numpy(rng.integers(0, VOCAB, size=TP_STEP_TOKENS))
                 .to(PAR_DEVICE) for _ in range(2)]
    with torch.no_grad():
        net.moe_routes = []
        want = net.apply(toks)
        want_routes, net.moe_routes = net.moe_routes, None
        one_ms = wall_ms(lambda: net.apply(toks), reps=1)
    scale = want.abs().max().item()
    dropped = 1.0 - torch.stack([k for _, k in want_routes]).float().mean()
    weights = to_jax_params(net)
    want_steps = sgd_losses(net, net.loss_fn(), step_rows)
    del net
    counts = None
    for label, mesh in parallel_cases(2, tp=True):
        n = mesh.shape["model"]
        lay = TinyCausalLM.from_jax_params(weights, **arch,
                                           device=PAR_DEVICE)
        lay.shard_params(mesh)
        with torch.no_grad():
            lay.moe_routes = []
            reset_launch_counts()
            got = lay.apply(toks, mesh=mesh, tp=True)
            sync_all()
            launched = dict(cuda_ops.launch_counts)
            routes, lay.moe_routes = lay.moe_routes, None
            err = (got - want).abs().max().item()
            del got
            ms = wall_ms(lambda: lay.apply(toks, mesh=mesh, tp=True), reps=1)
        same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                   for a, b in zip(routes, want_routes))
        steps = sgd_losses(lay, lay.loss_fn(mesh=mesh, tp=True), step_rows,
                           mesh=mesh,
                           param_shardings=lay.param_shardings(mesh))
        s_err = max(abs(a - b) for a, b in zip(steps, want_steps))
        ok = (err <= PAR_LOGIT_RTOL * scale and same
              and len(routes) == LAYERS and s_err <= PAR_LOSS_ATOL)
        print(f"  MoE experts={MOE_EXPERTS} {label} (1, {n}): apply(tp=True) "
              f"{list(MOE_TOKENS)} logits max abs {err:.3e} (limit 1e-4 x "
              f"{scale:.3f}), {ms:.1f} ms (unsplit {one_ms:.1f} ms), "
              f"launches {launched}; routing "
              f"{'equal' if same else 'DIFFERENT'} over {len(routes)} "
              f"layers, {100 * float(dropped):.2f}% of tokens dropped (over "
              f"capacity); 2 sgd steps' losses {steps} vs {want_steps} (max "
              f"|diff| {s_err:.2e}, limit {PAR_LOSS_ATOL:g}); "
              f"{'ok' if ok else 'MISS'}; card {card}", flush=True)
        LOCAL_FIGURES[f"MoE {label}"] = (
            f"apply(tp=True) {list(MOE_TOKENS)} {ms:.1f} ms (unsplit "
            f"{one_ms:.1f})")
        if not ok:
            problems.append(f"MoE {label}")
        if counts is None:
            counts = launched
        del lay
    return counts


def pp_leg(card, problems):
    """``apply_pipelined`` at serving width over 4 stages, 8 microbatches,
    against ``apply``; two sgd steps through each."""
    import torch.nn.functional as F

    from tpudl_torch import mesh as M
    from tpudl_torch.zoo.transformer import TinyCausalLM, arch_of

    spec = TinyCausalLM(VOCAB, DIM, HEADS, LAYERS, MAX_LEN, device="meta")
    weights = spec.init(SEED)
    rng = np.random.default_rng(SEED + 20)
    toks = torch.from_numpy(rng.integers(0, VOCAB, size=PP_TOKENS)).to(
        PAR_DEVICE)
    step_rows = [torch.from_numpy(rng.integers(0, VOCAB, size=PP_STEP_TOKENS))
                 .to(PAR_DEVICE) for _ in range(2)]
    n = torch.cuda.device_count()
    cases = [(f"{PP_STAGES} stages on one card",
              M.build_mesh(1, PP_STAGES, devices=[PAR_DEVICE] * PP_STAGES))]
    if n > 1:
        cases.append((f"{PP_STAGES} stages on {n} cards", M.build_mesh(
            1, PP_STAGES, devices=[f"cuda:{i % n}"
                                   for i in range(PP_STAGES)])))
    net = TinyCausalLM.from_jax_params(weights, **arch_of(spec),
                                       device=PAR_DEVICE)
    with torch.no_grad():
        want = net.apply(toks)
        one_ms = wall_ms(lambda: net.apply(toks), reps=1)
    scale = want.abs().max().item()
    want_steps = sgd_losses(net, net.loss_fn(), step_rows)

    def pp_loss(mesh):
        def loss(model, tokens):
            logits = model.apply_pipelined(tokens[:, :-1], mesh,
                                           n_micro=PP_MICRO)
            return F.cross_entropy(logits.float().flatten(0, 1),
                                   tokens[:, 1:].flatten().long())
        return loss

    for label, mesh in cases:
        net = TinyCausalLM.from_jax_params(weights, **arch_of(spec),
                                           device=PAR_DEVICE)
        with torch.no_grad():
            got = net.apply_pipelined(toks, mesh, n_micro=PP_MICRO)
            err = (got - want).abs().max().item()
            del got
            ms = wall_ms(lambda: net.apply_pipelined(toks, mesh,
                                                     n_micro=PP_MICRO),
                         reps=1)
        steps = sgd_losses(net, pp_loss(mesh), step_rows)
        s_err = max(abs(a - b) for a, b in zip(steps, want_steps))
        ok = err <= PAR_LOGIT_RTOL * scale and s_err <= PAR_LOSS_ATOL
        print(f"  PP {label}: apply_pipelined {list(PP_TOKENS)} n_micro="
              f"{PP_MICRO} logits max abs {err:.3e} (limit 1e-4 x "
              f"{scale:.3f}), {ms:.1f} ms (apply {one_ms:.1f} ms); 2 sgd "
              f"steps' losses at "
              f"{list(PP_STEP_TOKENS)} {steps} vs apply's {want_steps} (max "
              f"|diff| {s_err:.2e}, limit {PAR_LOSS_ATOL:g}); "
              f"{'ok' if ok else 'MISS'}; card {card}", flush=True)
        if not ok:
            problems.append(f"PP {label}")
        del net


def run_parallel(card):
    """Phase 16: LM parallelism on local meshes at full width. Every check
    runs and prints; the phase fails at its end if any did not hold.
    Returns the kernel launches of its paths."""
    from tpudl_torch.device import full_f32

    t_phase = time.perf_counter()
    problems = []
    counts = {}
    legs = (("parallel_ring_call", ring_kernel_leg),
            ("parallel_ring_lm", ring_lm_leg),
            ("parallel_long_context_step", long_context_leg),
            ("parallel_tp_apply", tp_leg),
            ("parallel_moe_apply", moe_leg),
            ("parallel_pp", pp_leg))
    with full_f32():
        for name, leg in legs:
            t0 = time.perf_counter()
            out = leg(card, problems)
            if out is not None:
                counts[name] = out
            print(f"  {leg.__name__}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
            torch.cuda.empty_cache()
    print(f"  phase 16: {time.perf_counter() - t_phase:.1f} s; card {card}")
    if problems:
        fail("phase 16: " + "; ".join(problems))
    return counts


# phase 17: the compile subsystem (tpudl_torch.compile: the program store
# over CUDA graphs, the kernel-build cache, buckets from the environment)
COMPILE_ROWS = 64                  # LMFeaturizer: 4 batches of [16, 1024]
COMPILE_IMAGE_ROWS = 512           # InceptionV3 bf16, unfused, batch 64
COMPILE_IMAGE_RTOL = {"float32": IMAGE_CPU_RTOL, "bfloat16": 1e-2}
COMPILE_LM_RTOL = 2e-5             # of max |y|, where the graph's kernels differ
COMPILE_GEN_PLENS = (17, 20, 25, 31)   # one pow2 rung: 32
COMPILE_GEN_NEW = 16
COMPILE_GEN_CPU = 2                # of the generate prompts, against the CPU
COMPILE_SERVE_PLENS = (5, 9, 17, 33, 40, 50, 64, 100)
COMPILE_SERVE_NEW = 16
COMPILE_SERVE_CACHE = 256
COMPILE_CHILD_ROWS = BATCH         # a cold-start child featurizes one batch
COMPILE_CHILD_TIMEOUT = 300


@contextlib.contextmanager
def aot_env(path):
    """The program store armed at ``path`` (``TPUDL_COMPILE_AOT``), or
    unarmed for None; the variable is put back after."""
    saved = os.environ.get("TPUDL_COMPILE_AOT")
    if path is None:
        os.environ.pop("TPUDL_COMPILE_AOT", None)
    else:
        os.environ["TPUDL_COMPILE_AOT"] = str(path)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("TPUDL_COMPILE_AOT", None)
        else:
            os.environ["TPUDL_COMPILE_AOT"] = saved


def compile_counts() -> dict:
    from tpudl_torch.obs import metrics

    return {k: metrics.counter(f"compile.{k}").value
            for k in ("hits", "misses", "programs_restored",
                      "programs_compiled", "observed")}


def compile_delta(before) -> dict:
    now = compile_counts()
    return {k: int(now[k] - before[k]) for k in now}


def held(what, got, want, rtol, card, problems) -> str:
    """``got`` against ``want``: bitwise, or within ``rtol`` of max |y|
    where a captured graph runs other kernels than the eager calls."""
    if got.shape != want.shape or not np.isfinite(got).all():
        problems.append(f"{what}: shape {got.shape}, finite "
                        f"{bool(np.isfinite(got).all())}")
        return "MISS"
    if np.array_equal(got, want):
        return "bit for bit"
    err = rel_err(got, want)
    if not err <= rtol:
        problems.append(f"{what}: {err:.3e} of max |y| (limit {rtol})")
    return f"{err:.3e} of max |y| (limit {rtol})"


def compile_lm_leg(weights, store, card, problems):
    """LMFeaturizer at phase 4's width with the store armed against
    unarmed: the first armed transform misses on its first batch only,
    the rest replay; 12 forward launches a batch in both; features equal;
    rows/s over IMAGE_WINDOWS windows, the arms in turn. Returns the
    armed counted run's launches."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.frame import Frame
    from tpudl_torch.ml import LMFeaturizer
    from tpudl_torch.obs import last_pipeline_report
    from tpudl_torch.text import ByteTokenizer
    from tpudl_torch.zoo.transformer import TinyCausalLM

    spec = TinyCausalLM(VOCAB, DIM, HEADS, LAYERS, MAX_LEN, device="meta")
    frame = Frame({"text": make_texts(COMPILE_ROWS, SEED + 40)})
    n_batches = -(-COMPILE_ROWS // BATCH)
    # one stage: armed or not, its function is the same; only the
    # executor's dispatch through the store differs
    st = LMFeaturizer(inputCol="text", outputCol="vec", model=spec,
                      weights=weights, tokenizer=ByteTokenizer(),
                      batchSize=BATCH)
    paths = {"unarmed": None, "armed": store}
    ys, counted = {}, {}
    for arm in ("unarmed", "armed", "armed again"):
        with aot_env(paths[arm.split()[0]]):
            if arm == "unarmed":
                st.transform(frame)            # loads and warms cuBLAS
            torch.cuda.synchronize()
            reset_launch_counts()
            before = compile_counts()
            t0 = time.perf_counter()
            y = np.stack(list(st.transform(frame)["vec"]))
            torch.cuda.synchronize()
            rate = COMPILE_ROWS / (time.perf_counter() - t0)
            rep = last_pipeline_report()
        n = dict(cuda_ops.launch_counts)
        d = compile_delta(before)
        counted[arm] = (rate, rep, n, d)
        ys[arm] = y
        calls = rep["stage_calls"]
        want = {"unarmed": (0, 0), "armed": (n_batches - 1, 1),
                "armed again": (n_batches, 0)}[arm]
        got = (calls.get("aot_hits", 0), calls.get("aot_misses", 0))
        print(f"  LMFeaturizer {arm}: {COMPILE_ROWS} rows in {n_batches} "
              f"batches, {rate:.1f} rows/s (this run); report aot "
              f"{rep['aot']}, aot_hits/aot_misses {got} (want {want}); "
              f"compile.* {d}; flash forward launches "
              f"{n['flash_attn_fwd']} (want {LAYERS} x {n_batches}"
              f"{', graph replays' if arm != 'unarmed' else ''}); card "
              f"{card}", flush=True)
        if got != want or rep["aot"] != (arm != "unarmed"):
            problems.append(f"LMFeaturizer {arm}: hits/misses {got}")
        if n["flash_attn_fwd"] != LAYERS * n_batches:
            problems.append(f"LMFeaturizer {arm}: launches {n}")
    for arm in ("armed", "armed again"):
        print(f"  LMFeaturizer {arm} features against unarmed: "
              f"{held('LMFeaturizer ' + arm, ys[arm], ys['unarmed'], COMPILE_LM_RTOL, card, problems)}")
    rates = {arm: [] for arm in paths}
    for _ in range(IMAGE_WINDOWS):
        for arm, path in paths.items():
            with aot_env(path):
                t0 = time.perf_counter()
                st.transform(frame)
                torch.cuda.synchronize()
                rates[arm].append(COMPILE_ROWS / (time.perf_counter() - t0))
    for arm, r in rates.items():
        print(f"  LMFeaturizer {arm}: {len(r)} windows (arms in turn): "
              f"median {median(r):.1f} rows/s (least {min(r):.1f}, most "
              f"{max(r):.1f}); card {card}")
    print(f"    armed report: {report_text(counted['armed again'][1])}")
    return counted["armed again"][2]


def compile_image_leg(store, card, problems):
    """InceptionV3 bf16 ``DeepImageFeaturizer``, unfused, over 512 structs
    with the store armed against without: ``warmup(299, 299)`` then
    ``transform`` misses nothing; features equal; images/s over
    IMAGE_WINDOWS windows and each arm's card idle share. The host-bound
    path per-batch graphs are for (no claim)."""
    from tpudl_torch.compile.store import PROGRAM_CACHE_SIZE
    from tpudl_torch.frame import Frame
    from tpudl_torch.ml import DeepImageFeaturizer

    frame = Frame({"image": image_structs(COMPILE_IMAGE_ROWS, (299, 299, 3),
                                          SEED + 41)})
    n_batches = -(-COMPILE_IMAGE_ROWS // IMAGE_BATCH)
    feat = DeepImageFeaturizer(
        inputCol="image", outputCol="f", modelName="InceptionV3",
        computeDtype="bfloat16", batchSize=IMAGE_BATCH, fuseSteps=1)
    paths = {"unarmed": None, "armed": store}

    def run():
        return np.stack(list(feat.transform(frame)["f"]))

    with aot_env(None):
        run()                                       # loads, warms cuDNN
        y0 = run()
    with aot_env(store):
        torch.cuda.synchronize()
        reserved0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        feat.warmup(299, 299)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        reserved1 = torch.cuda.memory_reserved()
        before = compile_counts()
        y1 = run()
        d = compile_delta(before)
    print(f"  InceptionV3 bf16 unfused: warmup(299, 299) captured the "
          f"executor's key in {warm_s:.2f} s; card memory reserved "
          f"{reserved0 / 2**20:.1f} -> {reserved1 / 2**20:.1f} MiB at the "
          f"capture (+{(reserved1 - reserved0) / 2**20:.1f}; the store "
          f"holds {PROGRAM_CACHE_SIZE} graphs at most); the transform after "
          f"it: "
          f"compile.* {d} (want {n_batches} hits, 0 misses); features "
          f"{held('InceptionV3 bf16 armed', y1, y0, COMPILE_IMAGE_RTOL['bfloat16'], card, problems)}"
          f" against unarmed; card {card}", flush=True)
    if d["misses"] or d["hits"] != n_batches:
        problems.append(f"InceptionV3 warmup then transform: {d}")
    rates = {arm: [] for arm in paths}
    for _ in range(IMAGE_WINDOWS):
        for arm, path in paths.items():
            with aot_env(path):
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                rates[arm].append(COMPILE_IMAGE_ROWS
                                  / (time.perf_counter() - t0))
    for arm, r in rates.items():
        with aot_env(paths[arm]):
            wall, busy, ev = idle_profile(run)
        print(f"  InceptionV3 bf16 {arm}: {len(r)} windows (arms in turn): "
              f"median {median(r):.1f} images/s (least {min(r):.1f}, most "
              f"{max(r):.1f}); card {card}")
        print(idle_text(f"InceptionV3 bf16 {arm}", wall, busy, ev, card))


def compile_generate_leg(weights, net, store, card, problems):
    """``generate`` through its graph: 4 prompts of ragged lengths in one
    pow2 rung, 16 new tokens each; tokens equal to eager ``generate`` on
    the card and 2 to the CPU port's; one graph for the rung; new tokens/s
    of the graph and of eager; the graph's memory."""
    from tpudl_torch.zoo.transformer import TinyCausalLM

    prompts = serve_prompts(COMPILE_GEN_PLENS, SEED + 42)

    def gen(p):
        return net.generate(p[None, :], COMPILE_GEN_NEW,
                            prompt_buckets="pow2").cpu().numpy()[0]

    with aot_env(None):
        gen(prompts[0])                                   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = [gen(p) for p in prompts]
        eager_s = time.perf_counter() - t0
    with aot_env(store):
        torch.cuda.synchronize()
        reserved0 = torch.cuda.memory_reserved()
        before = compile_counts()
        t0 = time.perf_counter()
        first = gen(prompts[0])                           # eager + capture
        first_s = time.perf_counter() - t0
        reserved1 = torch.cuda.memory_reserved()
        graph = [first] + [gen(p) for p in prompts[1:]]
        d = compile_delta(before)
        programs = len(net._gen_fns)     # the rung's one graph function
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = [gen(p) for p in prompts]
        graph_s = time.perf_counter() - t0
    equal = [bool(np.array_equal(a, b)) for a, b in zip(graph, eager)]
    equal_again = [bool(np.array_equal(a, b)) for a, b in zip(again, eager)]
    cpu = TinyCausalLM.from_jax_params(
        weights, vocab=VOCAB, dim=DIM, heads=HEADS, layers=LAYERS,
        max_len=MAX_LEN, device="cpu")
    cpu_equal = [bool(np.array_equal(
        cpu.generate(p[None, :], COMPILE_GEN_NEW).numpy()[0], g))
        for p, g in zip(prompts[:COMPILE_GEN_CPU], graph)]
    del cpu
    n_new = len(prompts) * COMPILE_GEN_NEW
    print(f"  generate, prompts {list(COMPILE_GEN_PLENS)} (pow2 rung 32), "
          f"{COMPILE_GEN_NEW} new tokens: graph tokens equal to eager on the "
          f"card {equal} and on replay {equal_again}; the first "
          f"{COMPILE_GEN_CPU} equal to the CPU port's {cpu_equal}; graph "
          f"functions {programs}, graphs captured {d['programs_compiled']} "
          f"(want 1 and 1); compile.* {d}; first call "
          f"(eager + capture) {first_s:.3f} s; new tokens/s: graph "
          f"{n_new / graph_s:.1f}, eager {n_new / eager_s:.1f}; card memory "
          f"reserved {reserved0 / 2**20:.1f} -> {reserved1 / 2**20:.1f} MiB "
          f"at the capture (+{(reserved1 - reserved0) / 2**20:.1f}); card "
          f"{card}", flush=True)
    if not all(equal + equal_again + cpu_equal) or programs != 1 \
            or d["programs_compiled"] != 1 or d["misses"] != 1 \
            or d["hits"] != len(prompts) - 1:
        problems.append(f"generate graph: equal {equal} {equal_again} "
                        f"{cpu_equal}, programs {programs}, {d}")


def compile_serve_leg(net, store, card, problems):
    """``precompile_serve`` through the registry with the store armed, then
    8 greedy slot streams equal to serial ``generate``, 0 captures after
    registration; and ``RungBatcher`` over the embed function through the
    store (one graph a rung, 12 forward launches a replay). Returns the
    batcher's launches."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.compile import get_program_store
    from tpudl_torch.device import full_f32
    from tpudl_torch.serve import ModelRegistry, RungBatcher
    from tpudl_torch.text import pad_mask

    with aot_env(store):
        t0 = time.perf_counter()
        entry = ModelRegistry().add_model(
            "lm", net, slots=SERVE_SLOTS, cache_len=COMPILE_SERVE_CACHE,
            warm=True)
        reg_s = time.perf_counter() - t0
        eng = entry.engine
        bound = sum(e["bound"] for e in get_program_store().entries()
                    .values())
        captures = eng.captures
        prompts = serve_prompts(COMPILE_SERVE_PLENS, SEED + 43)
        before = compile_counts()
        streams = serve_drain(eng, [_Probe(p, COMPILE_SERVE_NEW)
                                    for p in prompts])
        d = compile_delta(before)
    with aot_env(None):
        serial = [serve_serial(net, p, COMPILE_SERVE_NEW) for p in prompts]
    equal = [bool(np.array_equal(a, b)) for a, b in zip(streams, serial)]
    print(f"  precompile_serve through the registry: {reg_s:.2f} s, "
          f"warm_signatures {entry.warm_signatures} (want 3), {bound} serve "
          f"entries in the manifest, {captures} graphs; 8 greedy streams "
          f"(prompts {list(COMPILE_SERVE_PLENS)}, {COMPILE_SERVE_NEW} new) "
          f"equal to serial generate: {equal}; graphs captured after "
          f"registration {eng.captures - captures}; compile.* of the drain "
          f"{d}; card {card}", flush=True)
    if entry.warm_signatures != 3 or bound < 3 or not all(equal) \
            or eng.captures != captures or d["misses"]:
        problems.append(f"precompile_serve: {entry.warm_signatures}, "
                        f"{bound}, {equal}, {d}")

    def embed(tokens):
        with full_f32():
            t = torch.as_tensor(tokens, device=net.device)
            mask = pad_mask(t)
            h = net.hidden(t)
            pooled = (h * mask[..., None]).sum(dim=1)
            return pooled / mask.sum(dim=1, keepdim=True).clamp_min(1.0)

    rng = np.random.default_rng(SEED + 44)
    payloads = [rng.integers(1, VOCAB, (n, SERVE_BATCHER_BYTES + 1))
                for n in SERVE_BATCHER_ROWS]
    with torch.inference_mode():
        with aot_env(None):
            want = np.concatenate(RungBatcher(embed).run(payloads))
        with aot_env(store):
            batcher = RungBatcher(embed, device=net.device)
            batcher.run(payloads)                        # miss: captures
            torch.cuda.synchronize()
            reset_launch_counts()
            before = compile_counts()
            got = np.concatenate(batcher.run(payloads))
            torch.cuda.synchronize()
            d = compile_delta(before)
            launched = dict(cuda_ops.launch_counts)
    print(f"  RungBatcher over the embed function through the store: "
          f"compile.* {d} (want 1 hit), flash forward launches "
          f"{launched['flash_attn_fwd']} (want {LAYERS}, a replay); rows "
          f"{held('RungBatcher armed', got, want, COMPILE_LM_RTOL, card, problems)}"
          f" against unarmed; card {card}", flush=True)
    if d["hits"] != 1 or launched["flash_attn_fwd"] != LAYERS:
        problems.append(f"RungBatcher through the store: {d}, {launched}")
    return launched


def save_weights(weights, path):
    np.savez(path, **{f"{g}/{k}": a for g, leaves in weights.items()
                      for k, a in leaves.items()})


def load_weights(path) -> dict:
    out: dict = {}
    with np.load(path) as z:
        for name in z.files:
            g, k = name.split("/")
            out.setdefault(g, {})[k] = z[name]
    return out


def compile_child(kind, weights_path):
    """One cold-start child (``--compile-child``): from process start to
    the first result of ``kind`` — ``lm`` (LMFeaturizer over one batch)
    or ``gen`` (one greedy generate), with ``warm_start`` between building
    the model and the traffic — or, for ``kernels``, to the end of the
    nvcc build into an empty kernel directory. Prints one JSON line."""
    from tpudl_torch import compile as C
    from tpudl_torch.obs import last_pipeline_report

    out = {"kind": kind}
    if kind == "kernels":
        from tpudl_torch import _build

        out["t_warm"] = time.time()
        t0 = time.perf_counter()
        logs = _build.build()
        out["build_s"] = time.perf_counter() - t0
        out["t_first"] = time.time()
        out["built"] = sorted(logs)
        out["kernel_dir"] = str(_build.build_dir())
        print(json.dumps(out), flush=True)
        return
    weights = load_weights(weights_path)
    before = compile_counts()
    if kind == "lm":
        from tpudl_torch.frame import Frame
        from tpudl_torch.ml import LMFeaturizer
        from tpudl_torch.text import ByteTokenizer
        from tpudl_torch.zoo.transformer import TinyCausalLM

        spec = TinyCausalLM(VOCAB, DIM, HEADS, LAYERS, MAX_LEN,
                            device="meta")
        stage = LMFeaturizer(inputCol="text", outputCol="vec", model=spec,
                             weights=weights, tokenizer=ByteTokenizer(),
                             batchSize=BATCH)
        frame = Frame({"text": make_texts(COMPILE_CHILD_ROWS, SEED + 40)})
        out["restored"] = C.warm_start(block=True)
        out["t_warm"] = time.time()
        y = np.stack(list(stage.transform(frame)["vec"]))
        out["t_first"] = time.time()
        calls = last_pipeline_report()["stage_calls"]
        out["first_dispatch"] = ("hit" if calls.get("aot_hits") else "miss")
    else:
        from tpudl_torch.zoo.transformer import TinyCausalLM

        net = TinyCausalLM.from_jax_params(
            weights, vocab=VOCAB, dim=DIM, heads=HEADS, layers=LAYERS,
            max_len=MAX_LEN, device="cuda")
        prompt = serve_prompts(COMPILE_GEN_PLENS[:1], SEED + 42)[0]
        out["restored"] = C.warm_start(block=True)
        out["t_warm"] = time.time()
        y = net.generate(prompt[None, :], COMPILE_GEN_NEW,
                         prompt_buckets="pow2").cpu().numpy()
        out["t_first"] = time.time()
        out["tokens"] = y[0].tolist()
    d = compile_delta(before)
    out["compile"] = d
    if kind == "gen":
        out["first_dispatch"] = "hit" if d["hits"] else "miss"
    out["finite"] = bool(np.isfinite(y).all())
    print(json.dumps(out), flush=True)


def compile_cold_start_leg(weights, tmp, card, problems):
    """Two child processes per arm, started together, each timed from its
    start to its first result and from ``warm_start`` returning to it —
    arm A on an empty store each, arm B both on the manifest arm A's first
    child left — for LMFeaturizer and for generate; and one child on an
    empty kernel directory, which prints the nvcc build seconds."""
    import shutil

    wpath = os.path.join(tmp, "weights.npz")
    t0 = time.perf_counter()
    save_weights(weights, wpath)
    print(f"  cold start: the seeded weights written for the children in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    script = os.path.abspath(__file__)

    def children(kind, stores, cache_dir=None):
        """One child a store, all started together (the two of an arm run
        side by side); each one's result with its two times."""
        env = dict(os.environ)
        if cache_dir is not None:
            env["TPUDL_COMPILE_CACHE_DIR"] = cache_dir
        procs = []
        for store in stores:
            procs.append((time.time(), subprocess.Popen(
                [sys.executable, script, "--compile-child", kind, wpath],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=dict(env, TPUDL_COMPILE_AOT=store), cwd=os.getcwd())))
        outs = []
        for t_spawn, proc in procs:
            try:
                stdout, stderr = proc.communicate(
                    timeout=COMPILE_CHILD_TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, stderr = proc.communicate()
            lines = [ln for ln in stdout.splitlines()
                     if ln.startswith("{\"kind\"")]
            if proc.returncode or not lines:
                problems.append(f"cold-start child {kind}: rc "
                                f"{proc.returncode}")
                print(f"  child {kind} failed rc {proc.returncode}:\n"
                      f"{stdout[-2000:]}\n{stderr[-3000:]}", flush=True)
                outs.append(None)
                continue
            out = json.loads(lines[-1])
            out["start_to_first_s"] = out["t_first"] - t_spawn
            out["warm_to_first_s"] = out["t_first"] - out["t_warm"]
            outs.append(out)
        return outs

    results = {}
    for kind in ("lm", "gen"):
        a_dirs = [os.path.join(tmp, f"{kind}-A{i}") for i in (1, 2)]
        for arm, dirs in (("A", a_dirs), ("B", [a_dirs[0]] * 2)):
            for i, r in enumerate(children(kind, dirs)):
                results[(kind, arm, i)] = r
                if r is None:
                    continue
                want = "miss" if arm == "A" else "hit"
                print(f"  cold start {kind} arm {arm} child {i + 1}: process "
                      f"start to first result {r['start_to_first_s']:.2f} s, "
                      f"warm_start returning to it "
                      f"{r['warm_to_first_s']:.3f} s; restored "
                      f"{r['restored']}; first dispatch "
                      f"{r['first_dispatch']} (want {want}); compile.* "
                      f"{r['compile']}; card {card}", flush=True)
                if r["first_dispatch"] != want or not r["finite"]:
                    problems.append(f"cold start {kind} arm {arm}: {r}")
    gens = [results[("gen", a, i)] for a in "AB" for i in (0, 1)]
    if all(gens) and len({tuple(g["tokens"]) for g in gens}) != 1:
        problems.append("cold-start generate tokens differ by arm")
    kdir = os.path.join(tmp, "kernel-cache")
    r, = children("kernels", [os.path.join(tmp, "kernels-store")],
                  cache_dir=kdir)
    if r is not None:
        print(f"  cold start with an empty kernel directory "
              f"(TPUDL_COMPILE_CACHE_DIR={kdir}): nvcc built {r['built']} "
              f"into {r['kernel_dir']} in {r['build_s']:.1f} s; process "
              f"start to the built kernels {r['start_to_first_s']:.2f} s; "
              f"card {card}", flush=True)
        if not r["built"] or not r["kernel_dir"].startswith(kdir):
            problems.append(f"kernel-cache child: {r}")
    shutil.rmtree(kdir, ignore_errors=True)


def run_compile(card):
    """Phase 17: the compile subsystem at phase 4's width. Every check runs
    and prints; the phase fails at its end if any did not hold. Returns
    the kernel launches of its paths."""
    import shutil
    import tempfile

    from tpudl_torch.compile import reset_program_store
    from tpudl_torch.zoo.transformer import TinyCausalLM

    t_phase = time.perf_counter()
    problems = []
    tmp = tempfile.mkdtemp(prefix="tpudl-compile-")
    store = os.path.join(tmp, "programs")
    try:
        spec = TinyCausalLM(VOCAB, DIM, HEADS, LAYERS, MAX_LEN,
                            device="meta")
        weights = spec.init(SEED)
        counts = {}
        legs = (("compile_lm_leg", lambda: compile_lm_leg(
                    weights, store, card, problems)),
                ("compile_image_leg", lambda: compile_image_leg(
                    store, card, problems)),
                ("compile_generate_and_serve_legs", None),
                ("compile_cold_start_leg", lambda: compile_cold_start_leg(
                    weights, tmp, card, problems)))
        for name, leg in legs:
            t0 = time.perf_counter()
            if leg is None:
                with aot_env(None):
                    net = TinyCausalLM.from_jax_params(
                        weights, vocab=VOCAB, dim=DIM, heads=HEADS,
                        layers=LAYERS, max_len=MAX_LEN, device="cuda")
                compile_generate_leg(weights, net, store, card, problems)
                counts["compile_rung_batcher"] = compile_serve_leg(
                    net, store, card, problems)
                del net
            else:
                out = leg()
                if out is not None:
                    counts["compile_lm_featurizer"] = out
            print(f"  {name}: {time.perf_counter() - t0:.1f} s", flush=True)
            torch.cuda.empty_cache()
    finally:
        reset_program_store()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  phase 17: {time.perf_counter() - t_phase:.1f} s; card {card}")
    if problems:
        fail("phase 17: " + "; ".join(problems))
    return counts



# phase 18: the model axis over a process group — one card a rank, NCCL,
# the ranks spawned by HorovodRunner (tpudl_torch.collectives)
GROUP_ONE_RTOL = 1e-5              # a (1, 1) grid against no mesh
GROUP_RATE_STEPS = 5               # timed train steps after the checked ones
GROUP_RESTART_LAYERS = 2           # the restart leg's depth, at full width
GROUP_RESTART_STEPS, GROUP_FAIL_AT = 4, 2
# the kernels at the per-rank shapes of phase 18's grids: the heads of a 2-
# and a 4-way TP split at [4, 1024], and a ring rank's hops over 8192 tokens
# (name, q shape, Sk, causal, q_offset, k_offset)
GROUP_KERNEL_CASES = [
    ("2-way TP rank", (4, 1024, 8, 64), 1024, True, 0, 0),
    ("4-way TP rank", (4, 1024, 4, 64), 1024, True, 0, 0),
    ("ring rank 1 of 2, past", (1, 4096, 8, 64), 4096, True, 4096, 0),
    ("ring rank 3 of 4, past", (1, 2048, 8, 64), 2048, True, 6144, 2048),
    ("ring rank 3 of 4, diagonal", (1, 2048, 8, 64), 2048, True, 6144,
     6144)]


def group_kernel_leg(card, problems):
    """The three kernels against their plain versions at
    ``GROUP_KERNEL_CASES``, f32: the forward's O and lse (phase 3's
    tolerance), then dq, dk and dv under random dO and dlse cotangents
    (phase 3's, of max(1, max |grad|))."""
    from tpudl_torch import cuda_ops

    gen = torch.Generator().manual_seed(SEED + 21)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to("cuda")

    tol, gtol = TOL["float32"], GRAD_TOL["float32"]
    for name, (b, s_q, h, d), s_k, causal, q_off, k_off in GROUP_KERNEL_CASES:
        q, k, v = rand(b, s_q, h, d), rand(b, s_k, h, d), rand(b, s_k, h, d)
        kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
        o, lse = cuda_ops.flash_attention(q, k, v, return_lse=True, **kw)
        po, plse = cuda_ops.flash_attention_plain(q, k, v, return_lse=True,
                                                  **kw)
        o_err = (o - po).abs().max().item()
        l_err = (lse - plse).abs().max().item()
        do, dlse = rand(b, s_q, h, d), rand(b, s_q, h)
        got = cuda_ops.flash_attention_bwd(q, k, v, o, lse, do, dlse, **kw)
        want = cuda_ops.flash_attention_bwd_plain(q, k, v, o, lse, do, dlse,
                                                  **kw)
        errs = {n: ((g - w).abs().max().item(),
                    max(1.0, w.abs().max().item()))
                for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        ok = (o_err <= tol["o_abs"] and l_err <= tol["lse_abs"]
              and all(e <= gtol["abs"] * sc for e, sc in errs.values()))
        print(f"  kernels at {name} q{(b, s_q, h, d)} Sk={s_k} offsets "
              f"{q_off}/{k_off}: O max abs {o_err:.3e}, lse {l_err:.3e}; "
              + ", ".join(f"{n} {e:.3e}/{sc:.2e}" for n, (e, sc)
                          in errs.items())
              + f" {'ok' if ok else 'MISS'}; card {card}", flush=True)
        if not ok:
            problems.append(f"kernels at {name}")
        del q, k, v, o, lse, po, plse, do, dlse, got, want


def rank_ms(fn, dev, reps=1) -> float:
    """Host wall time of ``fn()`` on this rank, its card synchronised."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def rank_idle(fn, dev):
    """(wall ms, busy ms, NCCL ms) of one ``fn()`` on this rank's card,
    under torch.profiler tracing the card: busy sums the kernels and
    copies it ran, NCCL's part of it the collectives' kernels, which spin
    while a peer is late (so busy minus NCCL is the card's own work);
    through a marked capture."""
    from tpudl_torch.obs import trace as T

    prof, wall = card_capture(lambda: rank_ms(fn, dev), cpu=False)
    mine = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.device_index == dev.index
            and T.MARK_KERNEL not in e.name]
    busy = sum(e.self_device_time_total for e in mine) / 1e3
    nccl = sum(e.self_device_time_total for e in mine
               if "nccl" in e.name.lower()) / 1e3
    return wall, busy, nccl


def rank_host_ops(fn, dev, top=8):
    """(wall ms, [(self CPU ms, calls, op)]) of one ``fn()`` on this rank:
    the ops with the most self CPU time under torch.profiler (CPU
    activity only)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        wall = rank_ms(fn, dev)
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return wall, [(e.self_cpu_time_total / 1e3, e.count, e.key[:80])
                  for e in ops[:top]]


def host_ops_text(what, host) -> str:
    wall, ops = host
    return (f"  {what}: host profile, wall {wall:.1f} ms; the ops with the "
            "most self CPU time:\n" + "\n".join(
                f"    {ms:8.2f} ms x{n:<5d} {key}" for ms, n, key in ops))


def rank_gathered(obj):
    """``obj`` of every rank of the world, in rank order."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def split_bytes(net) -> tuple[int, int]:
    """(bytes of this rank's split leaves, bytes of those leaves whole)."""
    mine = sum(p.numel() * p.element_size() for p, _ in net.split_parameters())
    m = net._tp_group.shape["model"] if net._tp_group is not None else 1
    return mine, mine * m


def group_bytes(arch, b, s, n_data, n_model, rank):
    """The bytes each collective hands NCCL on ``rank`` of an ``(n_data,
    n_model)`` grid in one training step of ``loss_fn(mesh=, tp=)`` on
    ``[b, s]`` tokens, reckoned from the shapes (f32; a ring all-reduce
    moves about 2(m-1)/m of its payload over the links). The row
    collectives run under tp; the ring's hops, the loss's psum and the
    gradients' mean over the data axis under a data axis above 1."""
    L, D, H, E = arch["layers"], arch["dim"], arch["heads"], \
        arch.get("experts", 0)
    s_loc = s // n_data
    act = b * s_loc * D * 4                  # a block's [B, S/n, D]
    out = {}
    if n_model > 1:
        if E:
            cap = max(1, int(np.ceil(s * 2.0 / E)))
            buf = E * (b // n_model) * cap * D * 4
            out["reduce_sum (row)"] = L * act
            out["copy_in (row, backward)"] = L * (2 * act + D * E * 4)
            out["all_to_all (row)"] = L * 4 * buf
            out["gather (row)"] = L * act // n_model
        else:
            out["reduce_sum (row)"] = 2 * L * act
            out["copy_in (row, backward)"] = 2 * L * act
    if n_data > 1:
        i = rank // n_model
        kv = 2 * b * s_loc * (H // n_model) * (D // H) * 4
        sends = (i + 1 if i < n_data - 1 else 0) + i   # forward + backward
        out["ring hops (column)"] = L * sends * kv
        out["loss psum (column, both ways)"] = 8
    return out


def bytes_text(b: dict) -> str:
    return ", ".join(f"{k} {v / 2 ** 20:.1f} MiB" for k, v in b.items()) \
        or "none"


def group_tp_fn(ctx):
    """Phase 18 on a ``(1, m)`` grid: ``TinyCausalLM`` at phase 4's width,
    the heads and the MLP split over the model axis (``shard_params``):
    ``apply(tp=True)`` on ``TP_TOKENS`` (launches, ms), two sgd steps of
    ``make_train_step(param_shardings=)`` on ``TP_STEP_TOKENS`` and the
    step rate and idle share; then, on the rank's card, the unsplit model
    (logits, two sgd steps). Every rank's figures, gathered."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.device import full_f32
    from tpudl_torch.train import make_train_step, sgd
    from tpudl_torch.zoo.transformer import TinyCausalLM, arch_of

    mesh, dev = ctx.mesh, ctx.device
    spec = TinyCausalLM(VOCAB, DIM, HEADS, LAYERS, MAX_LEN, device="meta")
    weights = spec.init(SEED)
    rng = np.random.default_rng(SEED + 22)
    toks = torch.from_numpy(rng.integers(0, VOCAB, size=TP_TOKENS)).to(dev)
    rows = [torch.from_numpy(rng.integers(0, VOCAB, size=TP_STEP_TOKENS))
            .to(dev) for _ in range(2)]
    out = {"coords": mesh.coords}
    with full_f32():
        net = TinyCausalLM.from_jax_params(weights, **arch_of(spec),
                                           device=dev)
        net.shard_params(mesh)
        out["split"] = split_bytes(net)
        loss_fn = net.loss_fn(mesh=mesh, tp=True)
        step = make_train_step(loss_fn, mesh=mesh,
                               param_shardings=net.param_shardings(mesh))
        with torch.no_grad():
            reset_launch_counts()
            got = net.apply(toks, mesh=mesh, tp=True)
            torch.cuda.synchronize(dev)
            out["launches"] = dict(cuda_ops.launch_counts)
            out["ms"] = rank_ms(lambda: net.apply(toks, mesh=mesh, tp=True),
                                dev)
        opt = sgd(0.1)(net.parameters())
        out["steps"] = [step(net, opt, r).item() for r in rows]
        ms = rank_ms(lambda: step(net, opt, rows[0]), dev, GROUP_RATE_STEPS)
        out["steps_per_s"] = 1e3 / ms
        out["idle"] = rank_idle(lambda: step(net, opt, rows[0]), dev)
        # every rank profiles (the step's collectives need them all)
        out["host"] = rank_host_ops(lambda: step(net, opt, rows[0]), dev)
        del net, opt
        one = TinyCausalLM.from_jax_params(weights, **arch_of(spec),
                                           device=dev)
        with torch.no_grad():
            want = one.apply(toks)
            out["one_ms"] = rank_ms(lambda: one.apply(toks), dev)
        out["err"] = (got - want).abs().max().item()
        out["scale"] = want.abs().max().item()
        del got, want
        step1 = make_train_step(one.loss_fn())
        opt = sgd(0.1)(one.parameters())
        out["one_steps"] = [step1(one, opt, r).item() for r in rows]
        del one, opt
    return rank_gathered(out)


def group_moe_fn(ctx):
    """Phase 18's ``experts=8`` leg on an ``(n, m)`` grid: phase 16's MoE
    model (its seeded card weights on every rank), the experts split over
    the model axis and the sequence over the data axis: ``apply(tp=True)``
    on ``MOE_TOKENS`` (the rank's block, its routing, ms), two sgd steps
    of ``make_train_step(param_shardings=)``; then the unsplit model on
    the rank's card (its block of the logits and of the routing, two sgd
    steps). Every rank's figures, gathered."""
    from tpudl_torch.device import full_f32
    from tpudl_torch.train import make_train_step, sgd
    from tpudl_torch.zoo.transformer import TinyCausalLM

    mesh, dev = ctx.mesh, ctx.device
    arch = dict(vocab=VOCAB, dim=DIM, heads=HEADS, layers=LAYERS,
                max_len=MAX_LEN, experts=MOE_EXPERTS)
    rng = np.random.default_rng(SEED + 19)
    toks = torch.from_numpy(rng.integers(0, VOCAB, size=MOE_TOKENS)).to(dev)
    rows = [torch.from_numpy(rng.integers(0, VOCAB, size=TP_STEP_TOKENS))
            .to(dev) for _ in range(2)]
    r, s = mesh.axis_index("data"), MOE_TOKENS[1] // mesh.size
    out = {"coords": mesh.coords}
    with full_f32():
        net = TinyCausalLM(**arch, device=dev)
        card_moe_weights(net, SEED)
        net.shard_params(mesh)
        out["split"] = split_bytes(net)
        with torch.no_grad():
            net.moe_routes = []
            got = net.apply(toks, mesh=mesh, tp=True)
            routes, net.moe_routes = net.moe_routes, None
            out["ms"] = rank_ms(lambda: net.apply(toks, mesh=mesh, tp=True),
                                dev)
        step = make_train_step(net.loss_fn(mesh=mesh, tp=True), mesh=mesh,
                               param_shardings=net.param_shardings(mesh))
        opt = sgd(0.1)(net.parameters())
        out["steps"] = [step(net, opt, x).item() for x in rows]
        out["idle"] = rank_idle(lambda: step(net, opt, rows[0]), dev)
        del net, opt
        one = TinyCausalLM(**arch, device=dev)
        card_moe_weights(one, SEED)
        with torch.no_grad():
            one.moe_routes = []
            want = one.apply(toks)[:, r * s:(r + 1) * s]
            want_routes, one.moe_routes = one.moe_routes, None
            out["one_ms"] = rank_ms(lambda: one.apply(toks), dev)
        out["err"] = (got - want).abs().max().item()
        out["scale"] = want.abs().max().item()
        out["routing_equal"] = len(routes) == LAYERS and all(
            torch.equal(c, w[:, r * s:(r + 1) * s])
            for (c, _), (w, _) in zip(routes, want_routes))
        out["dropped"] = 1.0 - float(torch.stack(
            [k for _, k in want_routes]).float().mean())
        del got, want
        step1 = make_train_step(one.loss_fn())
        opt = sgd(0.1)(one.parameters())
        out["one_steps"] = [step1(one, opt, x).item() for x in rows]
        del one, opt
    return rank_gathered(out)


def group_ring_fn(ctx):
    """Phase 18's ring on an ``(n, 1)`` grid: README's long-context model
    (phase 16's ``LC_ARCH`` and row) through ``ctx.trainer(lm.loss_fn(
    mesh=), adamw(3e-4))``, every rank the whole row and its sequence
    block: the first-step gradients at ``LC_F64_SEQ`` tokens (after the
    data-axis mean) and, on rank 0, float64's; the first loss and, on rank
    0, the one-card loss; one step's launches, ``LC_STEPS`` timed steps
    and one step's idle share. Every rank's figures, gathered."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.device import full_f32
    from tpudl_torch.train import adamw, make_train_step, sgd
    from tpudl_torch.zoo.transformer import (TinyCausalLM, _leaf_groups,
                                             _param_groups)

    mesh, dev = ctx.mesh, ctx.device
    spec = TinyCausalLM(**LC_ARCH, device="meta")
    weights = spec.init(SEED)
    rows = np.random.default_rng(SEED + 17).integers(
        0, LC_ARCH["vocab"], size=(1, LC_SEQ)).astype(np.int32)
    short = torch.from_numpy(rows[:, :LC_F64_SEQ]).to(dev)
    out = {"coords": mesh.coords}
    with full_f32():
        net = TinyCausalLM.from_jax_params(weights, **LC_ARCH, device=dev)
        out["param_bytes"] = sum(p.numel() * p.element_size()
                                 for p in net.parameters())
        loss_fn = net.loss_fn(mesh=mesh, use_pallas=True)
        make_train_step(loss_fn, mesh=mesh)(
            net, sgd(0.0)(net.parameters()), short)
        got_g = {f"{g}.{k}": t.grad.detach().clone()
                 for g, grp in _param_groups(net).items()
                 for k, t in grp.items()}
        net.zero_grad(set_to_none=True)
        trainer = ctx.trainer(loss_fn, adamw(LR), log_every=1)

        def data(step):
            return rows

        _, opt, hist = trainer.fit(net, data, 1)
        out["first"] = hist[0]["loss"]
        reset_launch_counts()
        trainer.fit(net, data, 1, opt_state=opt)
        torch.cuda.synchronize(dev)
        out["launches"] = dict(cuda_ops.launch_counts)
        ms = rank_ms(lambda: trainer.fit(net, data, LC_STEPS,
                                         opt_state=opt), dev)
        out["steps_per_s"] = LC_STEPS * 1e3 / ms
        out["idle"] = rank_idle(lambda: trainer.fit(net, data, 1,
                                                    opt_state=opt), dev)
        # every rank profiles (the step's collectives need them all)
        out["host"] = rank_host_ops(
            lambda: trainer.fit(net, data, 1, opt_state=opt), dev)
        del net, trainer, opt
        if ctx.rank == 0:
            one = TinyCausalLM.from_jax_params(weights, **LC_ARCH,
                                               device=dev)
            with torch.no_grad():
                out["one_loss"] = one.loss_fn()(one, torch.from_numpy(
                    rows).to(dev)).item()
            p64 = {g: {k: t.detach().double().requires_grad_()
                       for k, t in grp.items()}
                   for g, grp in _leaf_groups(one).items()}
            del one
            lm_loss_f64(p64, short, LC_ARCH["heads"]).backward()
            want_g = {f"{g}.{k}": t.grad for g, grp in p64.items()
                      for k, t in grp.items()}
            out["g_scale"] = max(t.abs().max().item()
                                 for t in want_g.values())
            out["g_err"] = max((got_g[n].double() - want_g[n]).abs().max()
                               .item() for n in want_g)
            del p64, want_g
        del got_g
    return rank_gathered(out)


def group_restart_fn(ctx, steps, fail_at=None):
    """The restart leg on the rank's grid: phase 4's width at
    ``GROUP_RESTART_LAYERS`` layers, ``Trainer(param_shardings=)`` sgd over
    ``TP_STEP_TOKENS`` rows with a checkpoint every step (under
    HorovodRunner's ``checkpoint_dir``); ``fail_at`` raises on every rank
    at that step of the first attempt. Rank 0's losses and a digest of
    the whole params after the run (gathered over the row)."""
    import hashlib

    from tpudl_torch.device import full_f32
    from tpudl_torch.train import sgd
    from tpudl_torch.zoo.transformer import (TinyCausalLM, arch_of,
                                             to_jax_params)

    mesh, dev = ctx.mesh, ctx.device
    spec = TinyCausalLM(VOCAB, DIM, HEADS, GROUP_RESTART_LAYERS, MAX_LEN,
                        device="meta")
    net = TinyCausalLM.from_jax_params(spec.init(SEED), **arch_of(spec),
                                       device=dev)

    def data(step):
        if fail_at is not None and step == fail_at and ctx.attempt == 0:
            raise RuntimeError(f"injected failure at step {step}")
        return np.random.default_rng(SEED + 23 + step).integers(
            0, VOCAB, size=TP_STEP_TOKENS)

    trainer = ctx.trainer(net.loss_fn(mesh=mesh, tp=True), sgd(0.1),
                          log_every=1, save_every=1,
                          param_shardings=net.param_shardings(mesh))
    with full_f32():
        _, _, hist = trainer.fit(net, data, steps)
    params = to_jax_params(net)
    digest = hashlib.sha256(b"".join(params[g][k].tobytes()
                                     for g in sorted(params)
                                     for k in sorted(params[g])))
    return {"losses": [h["loss"] for h in hist],
            "digest": digest.hexdigest(), "attempt": ctx.attempt}


@contextlib.contextmanager
def mesh_model_env(m: int):
    """``TPUDL_MESH_MODEL=m`` for the block (HorovodRunner's ranks read
    it)."""
    old = os.environ.get("TPUDL_MESH_MODEL")
    os.environ["TPUDL_MESH_MODEL"] = str(m)
    try:
        yield
    finally:
        if old is None:
            del os.environ["TPUDL_MESH_MODEL"]
        else:
            os.environ["TPUDL_MESH_MODEL"] = old


def group_run(n_data, n_model, fn, runner=None, **kwargs):
    """``HorovodRunner(np=n_data * n_model, **runner).run(fn, **kwargs)``
    under ``TPUDL_MESH_MODEL=n_model``: rank 0's result."""
    from tpudl_torch.train import HorovodRunner

    with mesh_model_env(n_model):
        return HorovodRunner(np=n_data * n_model, **(runner or {})).run(
            fn, **kwargs)


def group_idle_text(ranks) -> str:
    return ", ".join(f"rank {i} {100 * (1 - b / w):.1f}% idle, "
                     f"{100 * (1 - (b - c) / w):.1f}% without NCCL's kernels"
                     f" ({b:.1f} of {w:.1f} ms busy, {c:.1f} in NCCL)"
                     for i, (w, b, c) in enumerate(r["idle"] for r in ranks))


def group_tp_leg(card, grid, problems):
    """The ``(1, m)`` grid's TP leg; returns rank 0's launches of one
    ``apply(tp=True)``."""
    n_data, m = grid
    ranks = group_run(n_data, m, group_tp_fn)
    rtol = GROUP_ONE_RTOL if m == 1 else PAR_LOGIT_RTOL
    err = max(r["err"] for r in ranks)
    scale = ranks[0]["scale"]
    s_err = max(abs(a - b) for r in ranks
                for a, b in zip(r["steps"], r["one_steps"]))
    even = m == 1 or all(0 < mine and mine * m == whole
                         for mine, whole in (r["split"] for r in ranks))
    launched = [r["launches"] for r in ranks]
    ok = (err <= rtol * scale and s_err <= PAR_LOSS_ATOL and even
          and all(c["flash_attn_fwd"] == LAYERS for c in launched))
    b = group_bytes(dict(layers=LAYERS, dim=DIM, heads=HEADS),
                    TP_STEP_TOKENS[0], TP_STEP_TOKENS[1] - 1, n_data, m, 0)
    print(f"  TP {grid}: apply(tp=True) {list(TP_TOKENS)} logits max abs "
          f"{err:.3e} (limit {rtol:g} x {scale:.3f}) of the unsplit model "
          f"on each rank's card; launches a rank {launched} (want "
          f"{LAYERS} forward); {ranks[0]['ms']:.1f} ms (unsplit "
          f"{ranks[0]['one_ms']:.1f} ms); split leaves "
          f"{[r['split'][0] for r in ranks]} bytes a rank of "
          f"{ranks[0]['split'][1]} "
          f"({'1/' + str(m) if even else 'NOT 1/m'}); 2 param_shardings sgd "
          f"steps {list(TP_STEP_TOKENS)}: losses {ranks[0]['steps']} vs one "
          f"card {ranks[0]['one_steps']} (max |diff| {s_err:.2e}, limit "
          f"{PAR_LOSS_ATOL:g}); {ranks[0]['steps_per_s']:.3f} steps/s; a "
          f"step's collectives on rank 0: {bytes_text(b)}; "
          f"{'ok' if ok else 'MISS'}; card {card}", flush=True)
    print(f"  TP {grid}: one step's idle share: {group_idle_text(ranks)}")
    print(host_ops_text(f"TP {grid}, one step on rank 0", ranks[0]["host"]))
    if not ok:
        problems.append(f"TP {grid}")
    return launched[0]


def group_moe_leg(card, grid, problems):
    """The ``experts=8`` leg over ``grid``: each rank's block and routing
    against the unsplit model, two sgd steps."""
    n_data, m = grid
    ranks = group_run(n_data, m, group_moe_fn)
    rtol = GROUP_ONE_RTOL if n_data * m == 1 else PAR_LOGIT_RTOL
    err = max(r["err"] / r["scale"] for r in ranks)
    s_err = max(abs(a - b) for r in ranks
                for a, b in zip(r["steps"], r["one_steps"]))
    same = all(r["routing_equal"] for r in ranks)
    ok = err <= rtol and same and s_err <= PAR_LOSS_ATOL
    b = group_bytes(dict(layers=LAYERS, dim=DIM, heads=HEADS,
                         experts=MOE_EXPERTS), TP_STEP_TOKENS[0],
                    TP_STEP_TOKENS[1] - 1, n_data, m, 0)
    print(f"  MoE experts={MOE_EXPERTS} {grid}: apply(tp=True) "
          f"{list(MOE_TOKENS)} each rank's block max abs err {err:.3e} of "
          f"its max |logit| (limit {rtol:g}) against the unsplit model on "
          f"its card, routing {'equal' if same else 'DIFFERENT'} on every "
          f"rank ({100 * ranks[0]['dropped']:.2f}% of tokens over "
          f"capacity); {ranks[0]['ms']:.1f} ms (unsplit "
          f"{ranks[0]['one_ms']:.1f} ms); split leaves "
          f"{[r['split'][0] for r in ranks]} bytes a rank of "
          f"{ranks[0]['split'][1]}; 2 sgd steps' losses {ranks[0]['steps']} "
          f"vs one card {ranks[0]['one_steps']} (max |diff| {s_err:.2e}, "
          f"limit {PAR_LOSS_ATOL:g}); a step's collectives on rank 0: "
          f"{bytes_text(b)}; {'ok' if ok else 'MISS'}; card {card}",
          flush=True)
    print(f"  MoE {grid}: one step's idle share: {group_idle_text(ranks)}")
    if not ok:
        problems.append(f"MoE {grid}")


def group_ring_leg(card, grid, problems):
    """The ring leg; returns each rank's launches of one step."""
    n_data, m = grid
    ranks = group_run(n_data, m, group_ring_fn)
    lead = ranks[0]
    l_err = abs(lead["first"] - lead["one_loss"])
    launched = [r["launches"] for r in ranks]
    want = [LC_ARCH["layers"] * (i + 1) for i in range(n_data)]
    counts_ok = all(all(v == w for v in c.values())
                    for c, w in zip(launched, want))
    ok = (l_err <= PAR_LOSS_ATOL and counts_ok
          and lead["g_err"] <= LC_GRAD_RTOL * lead["g_scale"])
    print(f"  ring {grid}: long-context training 1x{LC_SEQ - 1} tokens, "
          f"first loss {lead['first']:.6f}, one card {lead['one_loss']:.6f} "
          f"(|diff| {l_err:.2e}, limit {PAR_LOSS_ATOL:g}); first-step "
          f"gradients at 1x{LC_F64_SEQ - 1} tokens (the data-axis mean) max "
          f"abs {lead['g_err']:.3e} vs float64 (limit {LC_GRAD_RTOL:g} x "
          f"{lead['g_scale']:.3e}); one step's launches a rank {launched} "
          f"(want {want} each: i+1 a block on rank i); "
          f"{lead['steps_per_s']:.3f} steps/s, "
          f"{lead['steps_per_s'] * (LC_SEQ - 1):.0f} tokens/s; "
          f"{'ok' if ok else 'MISS'}; card {card}", flush=True)
    for i in range(n_data):
        b = group_bytes(LC_ARCH, 1, LC_SEQ - 1, n_data, m, i * m)
        if n_data > 1:
            b["gradients' mean (column)"] = lead["param_bytes"]
        print(f"    rank {i}: a step's collectives {bytes_text(b)}")
    print(f"  ring {grid}: one step's idle share: {group_idle_text(ranks)}")
    print(host_ops_text(f"ring {grid}, one step on rank {n_data - 1} (the "
                        "most hops)", ranks[-1]["host"]))
    if not ok:
        problems.append(f"ring {grid}")
    return launched


def group_restart_leg(card, grid, problems):
    """A save, a gang restart and a resume against the uninterrupted run,
    on the ``(1, m)`` grid."""
    import tempfile

    n_data, m = grid
    straight = group_run(n_data, m, group_restart_fn,
                         steps=GROUP_RESTART_STEPS)
    with tempfile.TemporaryDirectory(prefix="tpudl-group-ck-") as tmp:
        resumed = group_run(n_data, m, group_restart_fn,
                            dict(checkpoint_dir=tmp, max_restarts=1),
                            steps=GROUP_RESTART_STEPS, fail_at=GROUP_FAIL_AT)
        saved = sorted(os.listdir(tmp))
    ok = (resumed["attempt"] == 1
          and resumed["losses"] == straight["losses"][GROUP_FAIL_AT:]
          and resumed["digest"] == straight["digest"])
    print(f"  restart {grid}: {GROUP_RESTART_LAYERS} layers at phase 4's "
          f"width, sgd with a checkpoint a step, every rank failing at "
          f"step {GROUP_FAIL_AT} of the first attempt: resumed on attempt "
          f"{resumed['attempt']}, losses {resumed['losses']} vs the "
          f"uninterrupted {straight['losses']}, params' sha256 "
          f"{'equal' if resumed['digest'] == straight['digest'] else 'DIFFERENT'}"
          f" ({resumed['digest'][:12]}); files {saved}; "
          f"{'ok' if ok else 'MISS'}; card {card}", flush=True)
    if not ok:
        problems.append(f"restart {grid}")


def run_group(card):
    """Phase 18: the model axis over a process group, one card a rank.
    Every check runs and prints; the phase fails at its end if any did
    not hold. Returns the kernel launches of its paths."""
    t_phase = time.perf_counter()
    problems = []
    n = torch.cuda.device_count()
    group_kernel_leg(card, problems)
    if n == 1:
        print("  one visible card: NCCL refuses two ranks on one card, so "
              "phase 18 runs its legs on a (1, 1) grid over NCCL (a world "
              "of one) against the run without a mesh, and held the "
              "kernels above at the per-rank shapes of a 2- and a 4-way "
              "split and at a ring rank's hop offsets", flush=True)
        tp_grid = ring_grid = moe_grid = (1, 1)
    else:
        tp_grid, ring_grid = (1, n), (n, 1)
        moe_grid = (n // 2, 2) if n % 2 == 0 else (1, 1)
    counts = {}
    legs = ((tp_grid, group_tp_leg, "group_tp_apply"),
            (moe_grid, group_moe_leg, None),
            (ring_grid, group_ring_leg, "group_ring_step"),
            (tp_grid, group_restart_leg, None))
    for grid, leg, path in legs:
        t0 = time.perf_counter()
        got = leg(card, grid, problems)
        if path == "group_ring_step":
            for i, c in enumerate(got):
                counts[f"{path}_rank{i}"] = c
        elif path is not None:
            counts[path] = got
        print(f"  {leg.__name__} {grid}: {time.perf_counter() - t0:.1f} s",
              flush=True)
        torch.cuda.empty_cache()
    if LOCAL_FIGURES:
        print("  phase 16's local-mesh figures from this call, beside "
              "these: " + "; ".join(f"{k}: {v}" for k, v in
                                     LOCAL_FIGURES.items()))
    print(f"  phase 18: {time.perf_counter() - t_phase:.1f} s; card {card}")
    if problems:
        fail("phase 18: " + "; ".join(problems))
    return counts


# phase 19: jobs, faults and the supervisor (tpudl_torch.jobs,
# tpudl_torch.testing.faults, tpudl_torch.frame.supervisor,
# tpudl_torch.obs.flight)
JOB_STEPS, JOB_SAVE_EVERY, JOB_KILL_AT = 12, 4, 7
JOB_CHILD_TIMEOUT = 300
JOB_TEXTS = 64                     # the supervised LMFeaturizer: 4 batches
JOB_FUSE, JOB_DEPTH = 4, 4
JOB_STALE_MB = 256                 # resident device-cache entries at an OOM
JOB_SERVE_FAULT_TICK = 5


def job_material(lr: float) -> dict:
    """The job's identity: its model, data and optimizer."""
    return {"model": "TinyCausalLM:v50257:d512:h8:l12", "init_seed": SEED,
            "rows": f"training_rows({TRAIN_BATCH * JOB_STEPS})",
            "batch": TRAIN_BATCH, "optimizer": "adamw", "lr": lr}


def job_model():
    """Phase 4b's model from ``init(SEED)`` on the card."""
    from tpudl_torch.zoo.transformer import TinyCausalLM, load_jax_params

    lm = TinyCausalLM(**TRAIN_ARCH, device="cuda")
    load_jax_params(lm, lm.init(SEED))
    return lm


def job_parts(workdir, lr=LR):
    """The job's runtime (``JobSpec(kind="fit")``, a checkpoint every
    ``JOB_SAVE_EVERY`` steps), its trainer and its model."""
    from tpudl_torch.jobs import JobRuntime, JobSpec
    from tpudl_torch.train import Trainer, adamw

    lm = job_model()
    spec = JobSpec("fit", str(workdir), material=job_material(lr),
                   save_every=JOB_SAVE_EVERY)
    return JobRuntime(spec), Trainer(lm.loss_fn(), adamw(lr),
                                     log_every=1), lm


def job_data(rows):
    return lambda step: rows[step * TRAIN_BATCH:(step + 1) * TRAIN_BATCH]


def jobs_child(workdir, out):
    """One attempt of phase 19's job (``--jobs-child``): arms
    ``TPUDL_FAULT_PLAN``, runs ``JobRuntime.run_fit(exit_on_preempt=True)``
    and writes ``<out>.json`` (its seconds, steps run and kernel
    launches) and, when the job finishes, ``<out>.pt`` (the final
    ``state_dict``). A preempted attempt exits 75."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.obs import metrics
    from tpudl_torch.testing import faults

    faults.install_from_env()
    torch.backends.cudnn.deterministic = True
    rows = training_rows(TRAIN_BATCH * JOB_STEPS)
    rt, trainer, lm = job_parts(workdir)
    reset_launch_counts()
    record = {"rc": None}
    t0 = time.perf_counter()
    try:
        rt.run_fit(trainer, lm, job_data(rows), JOB_STEPS,
                   exit_on_preempt=True)
        torch.save({k: v.detach().cpu() for k, v in lm.state_dict().items()},
                   f"{out}.pt")
        record["rc"] = 0
    except SystemExit as e:
        record["rc"] = e.code
        raise
    finally:
        torch.cuda.synchronize()
        record.update(seconds=time.perf_counter() - t0,
                      steps=int(metrics.counter("train.steps").value),
                      launches=dict(cuda_ops.launch_counts))
        with open(f"{out}.json", "w") as f:
            json.dump(record, f)


def jobs_resume_leg(tmp, card, problems):
    """The preemption contract on phase 4b's model: an uninterrupted
    12-step run here, then a child SIGTERMed at step 7 (exit 75, a
    ``preempted`` manifest, a flight dump in the workdir) and a relaunch
    that resumes and finishes, bit for bit the uninterrupted run; a
    changed spec is refused. Returns the two attempts' kernel launches."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.jobs import JobRuntime, JobSpec, RC_PREEMPTED, \
        load_manifest
    from tpudl_torch.train import Trainer, adamw
    from tpudl_torch.testing import faults

    rows = training_rows(TRAIN_BATCH * JOB_STEPS)
    lm = job_model()
    reset_launch_counts()
    t0 = time.perf_counter()
    _, _, hist = Trainer(lm.loss_fn(), adamw(LR), log_every=1).fit(
        lm, job_data(rows), JOB_STEPS)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    ref_launches = dict(cuda_ops.launch_counts)
    want = {k: v.detach().cpu() for k, v in lm.state_dict().items()}
    del lm
    torch.cuda.empty_cache()
    print(f"  uninterrupted: {JOB_STEPS} steps of adamw on "
          f"{TRAIN_BATCH}x{TRAIN_SEQ} tokens in this process, {t_ref:.2f} s, "
          f"losses {[round(h['loss'], 5) for h in hist]}, launches "
          f"{ref_launches}; card {card}", flush=True)

    workdir = os.path.join(tmp, "job")
    script = os.path.abspath(__file__)

    def attempt(name, plan=None):
        env = dict(os.environ)
        env.pop(faults.PLAN_ENV, None)
        if plan is not None:
            env[faults.PLAN_ENV] = plan.to_env()
        out = os.path.join(tmp, name)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, script, "--jobs-child", workdir, out],
            capture_output=True, text=True, env=env, cwd=os.getcwd(),
            timeout=JOB_CHILD_TIMEOUT)
        wall = time.perf_counter() - t0
        try:
            with open(f"{out}.json") as f:
                rec = json.load(f)
        except OSError:
            rec = {}
        rec.update(rc=proc.returncode, wall=wall)
        if proc.returncode not in (0, RC_PREEMPTED):
            print(f"  child {name} failed rc {proc.returncode}:\n"
                  f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}",
                  flush=True)
        return rec, out

    a, _ = attempt("killed", faults.FaultPlan.kill_at_step(JOB_KILL_AT))
    m = load_manifest(workdir) or {}
    dumps = sorted(n for n in os.listdir(workdir)
                   if n.startswith("tpudl-dump-"))
    reason = None
    if dumps:
        import gzip

        with gzip.open(os.path.join(workdir, dumps[0]), "rt") as f:
            reason = json.load(f).get("reason")
    cursor = dict(m.get("cursor") or {})
    ok_a = (a["rc"] == RC_PREEMPTED and m.get("status") == "preempted"
            and cursor == {"step": JOB_KILL_AT + 1}
            and (m.get("checkpoint") or {}).get("step") == JOB_KILL_AT + 1
            and reason == "preempted_resumable")
    print(f"  attempt 1 (kill_at_step({JOB_KILL_AT}) through "
          f"TPUDL_FAULT_PLAN): exit {a['rc']} (want {RC_PREEMPTED}), wall "
          f"{a['wall']:.1f} s (run_fit {a.get('seconds', float('nan')):.2f}"
          f" s), {a.get('steps')} steps run, manifest status "
          f"{m.get('status')!r}, cursor {cursor}, checkpoint "
          f"{m.get('checkpoint')}, dumps {dumps} ({reason}); launches "
          f"{a.get('launches')}; {'ok' if ok_a else 'MISS'}; card {card}",
          flush=True)
    if not ok_a:
        problems.append("the SIGTERMed attempt")
    b, out_b = attempt("resumed")
    final = load_manifest(workdir) or {}
    start_b = JOB_STEPS - int(b.get("steps") or 0)
    rework = max(0, int(a.get("steps") or 0) - start_b)
    same = False
    if b["rc"] == 0 and os.path.exists(f"{out_b}.pt"):
        got = torch.load(f"{out_b}.pt")
        same = sorted(got) == sorted(want) and all(
            torch.equal(got[k], want[k]) for k in want)
    per_step = {name: [rec.get("launches", {}).get(name, 0)
                       / max(1, int(rec.get("steps") or 0))
                       for rec in (a, b)] for name in ref_launches}
    ok_b = (b["rc"] == 0 and final.get("status") == "done"
            and final.get("attempt") == 2 and rework <= JOB_SAVE_EVERY
            and same and all(v == [TRAIN_ARCH["layers"]] * 2
                             for v in per_step.values()))
    print(f"  attempt 2 (the same spec): exit {b['rc']}, wall "
          f"{b['wall']:.1f} s (run_fit {b.get('seconds', float('nan')):.2f}"
          f" s), resumed at step {start_b}, {b.get('steps')} steps run, "
          f"{rework} reworked (at most save_every={JOB_SAVE_EVERY}); "
          f"manifest {final.get('status')!r} attempt {final.get('attempt')}"
          f"; final state_dict bit for bit the uninterrupted run's: {same}; "
          f"launches a step of each kernel in attempts 1 and 2 {per_step} "
          f"(want {TRAIN_ARCH['layers']}); {'ok' if ok_b else 'MISS'}",
          flush=True)
    if not ok_b:
        problems.append("the resumed attempt")
    try:
        JobRuntime(JobSpec("fit", workdir, material=job_material(2 * LR),
                           save_every=JOB_SAVE_EVERY),
                   install_signals=False)._begin()
        refused = None
    except ValueError as e:
        refused = str(e)
    print(f"  a relaunch with a changed spec (lr {2 * LR}): "
          f"{'refused: ' + refused[:120] if refused else 'NOT refused'}")
    if not refused or "refusing to resume foreign state" not in refused:
        problems.append("a changed spec was not refused")
    return {name: a.get("launches", {}).get(name, 0)
            + b.get("launches", {}).get(name, 0) for name in ref_launches}


@contextlib.contextmanager
def env_vars(**values):
    """Set (or, for None, unset) environment variables for the block."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def jobs_frame_leg(spec, weights, tmp, card, problems):
    """Phase 4's ``LMFeaturizer`` over 64 texts with ``fuseSteps=4`` and
    ``dispatchDepth=4``, supervised (``TPUDL_FRAME_DEGRADE=1``): an
    injected OOM, three dispatch faults, a real allocator OOM and an
    exhausted ladder, each recovered run bit for bit the healthy one.
    Returns the launches of the counted recovered runs."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.data import device_cache as dc
    from tpudl_torch.device import full_f32
    from tpudl_torch.frame import Frame
    from tpudl_torch.frame import supervisor as sup
    from tpudl_torch.ml import LMFeaturizer
    from tpudl_torch.obs import flight, last_pipeline_report
    from tpudl_torch.testing import faults
    from tpudl_torch.text import ByteTokenizer
    from tpudl_torch.text.codec import pad_mask, tokenize_pack

    frame = Frame({"text": make_texts(JOB_TEXTS, SEED)})
    n_batches = -(-JOB_TEXTS // BATCH)
    feat = LMFeaturizer(inputCol="text", outputCol="vec", model=spec,
                        weights=weights, tokenizer=ByteTokenizer(),
                        batchSize=BATCH, fuseSteps=JOB_FUSE,
                        dispatchDepth=JOB_DEPTH)
    with env_vars(TPUDL_FRAME_DEGRADE=None):
        feat.transform(frame)          # loads, warms, captures the graph
    torch.cuda.synchronize()

    def park():
        """Resident, unpinned device-cache entries (another run's)."""
        cache = dc.get_device_cache()
        per = (JOB_STALE_MB << 20) // 4
        for i in range(4):
            pin = cache.put(("phase19-stale", i),
                            [torch.zeros(per // 4, device="cuda")])
            if pin is not None:
                pin.release()
        return cache.bytes_resident

    def arm(run, plan=None, **env):
        flight.get_recorder().reset()
        reset_launch_counts()
        t0 = time.perf_counter()
        with env_vars(**env), (plan.armed() if plan is not None
                               else contextlib.nullcontext()):
            y = run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rungs = [e["rung"] for e in flight.get_recorder().snapshot()["errors"]
                 if e["kind"] == "frame.degraded"]
        return y, dt, rungs, last_pipeline_report(), \
            dict(cuda_ops.launch_counts)

    def stage_run():
        return np.stack(list(feat.transform(frame)["vec"]))

    want_launch = LAYERS * n_batches
    y0, t_healthy, _, _, l0 = arm(stage_run, TPUDL_FRAME_DEGRADE=None)
    print(f"  healthy (unsupervised) LMFeaturizer over {JOB_TEXTS} texts, "
          f"fuseSteps={JOB_FUSE}, dispatchDepth={JOB_DEPTH}: "
          f"{t_healthy:.3f} s, flash forward launches "
          f"{l0['flash_attn_fwd']} (want {want_launch}); card {card}",
          flush=True)
    counts = {}
    legs = [
        ("injected_oom", "injected oom at frame.dispatch",
         faults.FaultPlan.oom("frame.dispatch"), ["evict_hbm"]),
        ("dispatch_faults", "three dispatch faults",
         faults.FaultPlan([{"point": "frame.dispatch", "action": "raise",
                            "first_calls": 3}]),
         ["dispatch_depth=2", "dispatch_depth=1", "fuse_steps=1"]),
    ]
    for key, name, plan, want_rungs in legs:
        resident = park()
        y, dt, rungs, rep, launches = arm(stage_run, plan,
                                          TPUDL_FRAME_DEGRADE=1)
        left = dc.get_device_cache().bytes_resident
        evicted = want_rungs[0] != "evict_hbm" or left == 0
        ok = (rungs == want_rungs and np.array_equal(y, y0)
              and rep.get("degraded_to") == want_rungs[-1]
              and launches["flash_attn_fwd"] == want_launch and evicted)
        print(f"  {name}: rungs {rungs}, degraded_to "
              f"{rep.get('degraded_to')!r}, recovered_batches "
              f"{rep.get('recovered_batches')}, {dt:.3f} s against the "
              f"healthy {t_healthy:.3f} s, flash forward launches "
              f"{launches['flash_attn_fwd']} (want {want_launch}), device "
              f"cache {resident / 2**20:.0f} MB resident before, "
              f"{left / 2**20:.0f} MB after; features bit for bit the "
              f"healthy run's: {bool(np.array_equal(y, y0))}; "
              f"{'ok' if ok else 'MISS'}; card {card}", flush=True)
        if not ok:
            problems.append(name)
        counts[f"jobs_featurizer_{key}"] = launches
        dc.reset_device_cache()

    # a real allocator OOM: fn's first call asks for more than is free
    net, tok = feat._require()
    pack = tokenize_pack(tok, seq_len=None, buckets="pow2", bos=True)
    state = {"oom": False, "asked": 0}

    def greedy(tokens):
        if state["oom"]:
            state["oom"] = False
            free, _ = torch.cuda.mem_get_info()
            state["asked"] = free + (1 << 30)
            torch.empty(state["asked"], dtype=torch.uint8, device="cuda")
        mask = pad_mask(tokens)
        h = net.hidden(tokens)
        pooled = (h * mask[..., None]).sum(dim=1)
        return pooled / mask.sum(dim=1, keepdim=True).clamp_min(1.0)

    def direct():
        with torch.inference_mode(), full_f32():
            out = frame.map_batches(greedy, ["text"], ["vec"],
                                    batch_size=BATCH, pack=pack,
                                    fuse_steps=1, dispatch_depth=JOB_DEPTH)
        return np.stack(list(out["vec"]))

    y1, t_direct, _, _, _ = arm(direct, TPUDL_FRAME_DEGRADE=None)
    resident = park()
    state["oom"] = True
    y, dt, rungs, rep, launches = arm(direct, TPUDL_FRAME_DEGRADE=1)
    left = dc.get_device_cache().bytes_resident
    ok = (rungs == ["evict_hbm"] and np.array_equal(y, y1) and left == 0
          and launches["flash_attn_fwd"] == want_launch)
    print(f"  a real allocator OOM (fn's first call asked "
          f"{state['asked'] / 2**30:.1f} GiB, more than mem_get_info's free)"
          f": rungs {rungs}, {dt:.3f} s against the healthy run of the same "
          f"fn {t_direct:.3f} s, flash forward launches "
          f"{launches['flash_attn_fwd']}, device cache "
          f"{resident / 2**20:.0f} -> {left / 2**20:.0f} MB; bit for bit "
          f"the healthy run: {bool(np.array_equal(y, y1))} (and the stage's"
          f": {bool(np.array_equal(y1, y0))}); {'ok' if ok else 'MISS'}",
          flush=True)
    if not ok:
        problems.append("real OOM")
    counts["jobs_featurizer_real_oom"] = launches
    dc.reset_device_cache()

    # exhaustion: every dispatch fails, one rung of budget
    dump_dir = os.path.join(tmp, "dumps")
    every = faults.FaultPlan([{"point": "frame.dispatch",
                               "action": "raise"}])
    t0 = time.perf_counter()
    try:
        arm(stage_run, every, TPUDL_FRAME_DEGRADE=1,
            TPUDL_FRAME_DEGRADE_MAX_RUNGS=1, TPUDL_FLIGHT_DIR=dump_dir)
        err = None
    except sup.FaultError as e:
        err = e
    dumps = (sorted(os.listdir(dump_dir)) if os.path.isdir(dump_dir)
             else [])
    ok = (isinstance(err, sup.StageFault)
          and err.rungs == ("dispatch_depth=2", "serial")
          and isinstance(err.__cause__, faults.FaultInjected)
          and len(dumps) == 1)
    print(f"  TPUDL_FRAME_DEGRADE_MAX_RUNGS=1 under a fault at every "
          f"dispatch: {type(err).__name__} after rungs "
          f"{getattr(err, 'rungs', None)} in "
          f"{time.perf_counter() - t0:.3f} s, dump {dumps}; "
          f"{'ok' if ok else 'MISS'}", flush=True)
    if not ok:
        problems.append("exhaustion")
    return counts


def jobs_serve_leg(spec, weights, card, problems):
    """Phase 15's engine: 8 greedy requests through a supervised server
    with a fault at ``serve.dispatch`` on tick 5; the in-flight requests
    are requeued, every stream equals serial ``generate``, and no graph
    is captured after registration."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.serve import ModelRegistry, RequestQueue, Server
    from tpudl_torch.testing import faults

    reg = ModelRegistry()
    t0 = time.perf_counter()
    entry = reg.add_model("lm", spec, weights, slots=SERVE_SLOTS,
                          cache_len=SERVE_CACHE, warm=True)
    t_reg = time.perf_counter() - t0
    eng = entry.engine
    warm = eng.captures
    prompts = serve_prompts(SERVE_PARITY_PLENS, SEED)
    srv = Server(reg, RequestQueue(cap=64), supervise=True)
    reqs = [srv.submit(p, SERVE_MAX_NEW, model="lm") for p in prompts]
    srv._stop.set()
    plan = faults.FaultPlan([{"point": "serve.dispatch", "action": "raise",
                              "at_call": JOB_SERVE_FAULT_TICK}])
    reset_launch_counts()
    t0 = time.perf_counter()
    with plan.armed():
        summary = srv.run()
    t_run = time.perf_counter() - t0
    launches = dict(cuda_ops.launch_counts)
    streams = [np.asarray(r.result(timeout=SERVE_TIMEOUT)) for r in reqs]
    serial = [serve_serial(eng.model, p, SERVE_MAX_NEW) for p in prompts]
    equal = [bool(np.array_equal(a, b)) for a, b in zip(streams, serial)]
    ok = (all(equal) and eng.captures == warm and len(plan.fired) == 1
          and summary["degraded_to"] == "dispatch_depth=4"
          and summary["completed"] == len(prompts)
          and not any(launches.values()))
    print(f"  supervised server: registration {t_reg:.2f} s ({warm} graphs), "
          f"{len(prompts)} greedy requests x {SERVE_MAX_NEW} tokens with a "
          f"fault at serve.dispatch on tick {JOB_SERVE_FAULT_TICK}: "
          f"{t_run:.2f} s, degraded_to {summary['degraded_to']!r} (admission "
          f"width 8 -> 4), completed {summary['completed']}, streams equal "
          f"to serial generate {equal}, graphs captured after registration "
          f"{eng.captures - warm}, flash launches {launches}; "
          f"{'ok' if ok else 'MISS'}; card {card}", flush=True)
    if not ok:
        problems.append("supervised serving")
    del reg, entry, eng
    torch.cuda.empty_cache()
    return launches


def run_jobs(card):
    """Phase 19: jobs, faults and the supervisor at full width. Every
    check runs and prints; the phase fails at its end if any did not
    hold. Returns the kernel launches of its paths."""
    import tempfile

    from tpudl_torch.zoo.transformer import TinyCausalLM

    t_phase = time.perf_counter()
    problems = []
    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # phase 8's restart flags
    counts = {}
    try:
        with tempfile.TemporaryDirectory(prefix="tpudl-jobs-") as tmp:
            t0 = time.perf_counter()
            counts["jobs_run_fit_resumed"] = jobs_resume_leg(tmp, card,
                                                             problems)
            print(f"  jobs_resume_leg: {time.perf_counter() - t0:.1f} s",
                  flush=True)
            spec = TinyCausalLM(VOCAB, DIM, HEADS, LAYERS, MAX_LEN,
                                device="meta")
            weights = spec.init(SEED)
            t0 = time.perf_counter()
            counts.update(jobs_frame_leg(spec, weights, tmp, card,
                                         problems))
            print(f"  jobs_frame_leg: {time.perf_counter() - t0:.1f} s",
                  flush=True)
            t0 = time.perf_counter()
            counts["jobs_supervised_serving"] = jobs_serve_leg(
                spec, weights, card, problems)
            print(f"  jobs_serve_leg: {time.perf_counter() - t0:.1f} s",
                  flush=True)
    finally:
        torch.backends.cudnn.deterministic = saved_det
    torch.cuda.empty_cache()
    print(f"  phase 19: {time.perf_counter() - t_phase:.1f} s; card {card}")
    if problems:
        fail("phase 19: " + "; ".join(problems))
    return counts


# -- phase 20: the rest of observability -----------------------------------

OBS_TEXTS = 64                     # LMFeaturizer at phase 4's width: 4 batches
OBS_FUSE = 4                       # the fused arm: the 4 batches as 1 replay
OBS_IMAGE_ROWS = 512               # InceptionV3 bf16 at 299x299, batch 64
OBS_WINDOWS = 3                    # timed windows of each arm, in turn
OBS_OVERHEAD_ROUNDS = 3            # the overhead leg's rounds of its arms
OBS_STALL_S = 0.5                  # TPUDL_WATCHDOG_STALL_S of the stall leg
OBS_STALL_SLEEP_S = 1.5            # the frozen prepare of the stall leg
OBS_SERVE_REQUESTS, OBS_SERVE_CLIENTS, OBS_SERVE_NEW = 16, 4, 8
OBS_KERNELS = {"flash_attn_fwd": "flash_fwd_kernel",
               "flash_attn_bwd_dq": "flash_bwd_dq_kernel",
               "flash_attn_bwd_dkv": "flash_bwd_dkv_kernel"}


def obs_kernel_events(events) -> dict:
    """{launch counter name: kernel events on the trace's device lanes}
    for the three flash kernels, by their demangled names."""
    from tpudl_torch.obs import trace as T

    out = {name: 0 for name in OBS_KERNELS}
    for e in T.device_events(events):
        for name, fn in OBS_KERNELS.items():
            if fn + "<" in e["name"] or e["name"].startswith(fn):
                out[name] += 1
    return out


def obs_profiled(what, fn, tmp, card, problems):
    """Run ``fn`` once under ``obs.profile`` with the launch counters
    reset: the merged host/device summary, the flash kernels the device
    lanes name, and the launch counters. A capture without CUDA activity
    fails the phase."""
    from tpudl_torch import cuda_ops, obs
    from tpudl_torch.obs import trace as T

    d = os.path.join(tmp, what.replace(" ", "_"))
    for attempt in (1, 2):
        reset_launch_counts()
        try:
            with obs.profile(d) as prof:
                fn()
            break
        except T.TruncatedCapture as e:
            if attempt == 2:
                raise
            print(f"    {e}; the capture is taken again", flush=True)
    launches = dict(cuda_ops.launch_counts)
    cap = prof.capture
    host = obs.export_chrome_trace(os.path.join(d, "run.host.trace.json"),
                                   window="profile")
    events = T.load_trace_events(d)
    s = T.summarize_merged(T.load_host_trace_events(host), events)
    named = obs_kernel_events(events)
    if not s["device"]["module_count"]:
        problems.append(f"{what}: the profile recorded no CUDA activity")
    if cap["truncated"]:
        problems.append(f"{what}: a truncated capture {cap}")
    top = ", ".join(f"{o['name'][:48]} {o['us'] / 1e3:.2f} ms x{o['count']}"
                    for o in s["top_ops"][:3])
    busy = s["device_busy_frac"]
    print(f"  {what}: merged timeline: {s['device']['module_count']} device "
          f"events, device busy {s['device_busy_us'] / 1e3:.1f} ms"
          + (f" ({100 * busy:.1f}% of the device window)" if busy else "")
          + f", host spans {sum(s['host_stage_calls'].values())} "
          f"({', '.join(f'{k} x{v}' for k, v in sorted(s['host_stage_calls'].items()) if k.startswith('frame.'))}), "
          f"host/device overlap {s['overlap_us'] / 1e3:.1f} ms; flash "
          f"kernels on the device lanes {named}, launch counters "
          f"{launches}; top device ops: {top}; capture: "
          f"{cap['head_seen']} of {cap['head_marks']} head markers (device "
          f"events lost at its head: {cap['head_lost']}), closing marker "
          f"{'seen' if cap['tail_seen'] else 'MISSING'}, launches without "
          f"a kernel {cap['launches_without_kernel']}"
          f"{', TRUNCATED' if cap['truncated'] else ''}; process age "
          f"{time.perf_counter() - T_START:.0f} s; card {card}", flush=True)
    return s, named, launches


def obs_timeline_leg(spec, weights, tmp, card, problems):
    """Phase 4's ``LMFeaturizer`` over 64 texts armed: the tracer, the
    watchdog daemon, a status directory and ``obs.scope(tenant=)``, under
    ``obs.profile``. The merged timeline's device lanes name the flash
    forward kernel as often as the launch counter counts it (12 a batch),
    per-batch and under a fused graph replay; the device busy share
    beside phase 7's idle-share method; the status file validates and
    names the tenant; the ledger reconciles."""
    import importlib.util

    from tpudl_torch import obs
    from tpudl_torch.frame import Frame
    from tpudl_torch.ml import LMFeaturizer
    from tpudl_torch.obs import live, watchdog
    from tpudl_torch.text import ByteTokenizer

    frame = Frame({"text": make_texts(OBS_TEXTS, SEED + 20)})
    n_batches = -(-OBS_TEXTS // BATCH)
    want = LAYERS * n_batches
    stages = {arm: LMFeaturizer(inputCol="text", outputCol="vec",
                                model=spec, weights=weights,
                                tokenizer=ByteTokenizer(), batchSize=BATCH,
                                fuseSteps=fuse)
              for arm, fuse in (("per-batch", 1), ("fused", OBS_FUSE))}
    outs = {arm: np.stack(list(st.transform(frame)["vec"]))
            for arm, st in stages.items()}        # loads, warms, captures
    status = os.path.join(tmp, "status")
    counts = {}
    with env_vars(TPUDL_STATUS_DIR=status, TPUDL_STATUS_INTERVAL_S="0.2"):
        obs.start_watchdog(stall_s=30.0)
        try:
            for arm, st in stages.items():
                with obs.scope(tenant="phase20-lm"):
                    got = {}
                    s, named, launches = obs_profiled(
                        f"LMFeaturizer {arm}", lambda: got.update(
                            y=np.stack(list(st.transform(frame)["vec"]))),
                        tmp, card, problems)
                counts[f"obs_lm_{arm}"] = launches
                bitwise = np.array_equal(got["y"], outs[arm])
                ok = (launches["flash_attn_fwd"] == want and bitwise
                      and (named["flash_attn_fwd"] == want
                           or arm == "fused"))
                print(f"  LMFeaturizer {arm}: flash forward {named['flash_attn_fwd']} "
                      f"kernel events on the device lanes, launch counter "
                      f"{launches['flash_attn_fwd']} (want {LAYERS} a batch "
                      f"x {n_batches} = {want}); features bit for bit the "
                      f"unprofiled run: {bitwise}"
                      + ("" if named["flash_attn_fwd"] == want or arm != "fused"
                         else "; the replay's kernels are not traced one "
                              "by one, so the per-batch arm is the count")
                      + f"; {'ok' if ok else 'MISS'}; card {card}",
                      flush=True)
                if not ok:
                    problems.append(f"LMFeaturizer {arm} timeline")
                wall, busy, ev = idle_profile(
                    lambda: st.transform(frame))
                print(idle_text(f"LMFeaturizer {arm} (phase 7's method)",
                                wall, busy, ev, card))
            path = live.write_status()
        finally:
            watchdog.stop_watchdog()
            live.stop_status_writer()
    errs = ["no status file"]
    if path is not None:
        spec_v = importlib.util.spec_from_file_location(
            "validate_status", os.path.join(REPO_DIR, "tools",
                                            "validate_status.py"))
        if spec_v is None:
            errs = ["tools/validate_status.py missing"]
        else:
            sys.path.insert(0, os.path.join(REPO_DIR, "tools"))
            try:
                mod = importlib.util.module_from_spec(spec_v)
                spec_v.loader.exec_module(mod)
                errs = mod.validate_status(path)
            finally:
                sys.path.pop(0)
    payload = json.load(open(path)) if path else {}
    scopes = (payload.get("ledger") or {}).get("scopes") or {}
    rec = obs.reconcile()
    ok = (not errs and "tenant=phase20-lm" in scopes and rec["ok"]
          and "card" in (payload.get("hbm") or {}))
    print(f"  status file {path}: validate_status {errs or 'ok'}; tenants "
          f"{sorted(scopes)}; hbm.card {(payload.get('hbm') or {}).get('card')}"
          f"; ledger reconciled: {rec['ok']}; {'ok' if ok else 'MISS'}",
          flush=True)
    if not ok:
        problems.append("status file / ledger")
    return counts


def obs_training_leg(tmp, card, problems):
    """One step of phase 4b's model under ``obs.profile``: the device
    lanes name dq and dk/dv as often as their launch counters (12 each)."""
    from tpudl_torch.train import Trainer, adamw
    from tpudl_torch.zoo.transformer import TinyCausalLM, load_jax_params

    lm = TinyCausalLM(**TRAIN_ARCH, device="cuda")
    load_jax_params(lm, lm.init(SEED))
    rows = training_rows(TRAIN_BATCH * 2)
    trainer = Trainer(lm.loss_fn(), adamw(LR))
    _, opt, _ = trainer.fit(lm, lambda s: rows[:TRAIN_BATCH], 1)  # warm
    s, named, launches = obs_profiled(
        "training step", lambda: trainer.fit(
            lm, lambda s: rows[TRAIN_BATCH:], 1, opt_state=opt),
        tmp, card, problems)
    want = TRAIN_ARCH["layers"]
    ok = all(named[k] == launches[k] == want
             for k in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"))
    print(f"  training step: dq {named['flash_attn_bwd_dq']} and dk/dv "
          f"{named['flash_attn_bwd_dkv']} kernel events, launch counters "
          f"{launches} (want {want} each); {'ok' if ok else 'MISS'}; card "
          f"{card}", flush=True)
    if not ok:
        problems.append("training step timeline")
    del lm, opt, trainer
    torch.cuda.empty_cache()
    return launches


def obs_autotune_leg(spec, weights, card, problems):
    """``map_batches(autotune=)`` (``TPUDL_FRAME_AUTOTUNE``) on
    InceptionV3 bf16 unfused and on ``LMFeaturizer``: each autotuned run
    seeds from the run before it (the arms alternate, so from the other
    arm's report); the seeds printed; rows/s of 3 interleaved windows an
    arm; outputs bit for bit."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.frame import Frame
    from tpudl_torch.ml import DeepImageFeaturizer, LMFeaturizer
    from tpudl_torch.obs import last_pipeline_report, roofline
    from tpudl_torch.text import ByteTokenizer

    cases = {
        "InceptionV3 bf16 unfused": (
            DeepImageFeaturizer(inputCol="image", outputCol="y",
                                modelName="InceptionV3",
                                computeDtype="bfloat16",
                                batchSize=IMAGE_BATCH, fuseSteps=1),
            Frame({"image": image_structs(OBS_IMAGE_ROWS, (299, 299, 3),
                                          SEED + 21)}), "images/s"),
        "LMFeaturizer": (
            LMFeaturizer(inputCol="text", outputCol="y", model=spec,
                         weights=weights, tokenizer=ByteTokenizer(),
                         batchSize=BATCH),
            Frame({"text": make_texts(OBS_TEXTS, SEED + 20)}), "rows/s")}
    counts = {}
    for what, (stage, frame, unit) in cases.items():
        def run():
            return np.stack(list(stage.transform(frame)["y"]))

        with env_vars(TPUDL_FRAME_AUTOTUNE="0"):
            run()                                   # loads, warms
            y0 = run()
        # the advisor's device time: the card's busy time of an untuned
        # run under the profiler, over its dispatches (CUDA events around
        # a dispatch would also time the card's waits for the enqueue)
        with env_vars(TPUDL_FRAME_AUTOTUNE="0"):
            wall, busy, _ = idle_profile(run)
            event_ms = cuda_ms(run, reps=1)
        n_disp = last_pipeline_report()["stage_calls"]["dispatch"]
        device_ms = busy / n_disp
        rr = roofline.analyze(roofline.model_report(last_pipeline_report()),
                              device_ms_per_dispatch=device_ms,
                              publish=False, allow_probe=False)
        print(f"  {what}: device {device_ms:.2f} ms a dispatch (busy "
              f"{busy:.1f} ms of {wall:.1f} under the profiler, over "
              f"{n_disp} dispatches; CUDA events around the whole run "
              f"read {event_ms / n_disp:.2f} ms a dispatch); the advisor: "
              f"{rr.verdict if rr else None}; advice "
              f"{[(a['knob'], a['current'], a['recommended']) for a in (rr.advice if rr else [])]}",
              flush=True)
        rates = {"off": [], "autotune": []}
        seeds, equal = [], []
        reset_launch_counts()
        for _ in range(OBS_WINDOWS):
            for arm in rates:
                with env_vars(TPUDL_FRAME_AUTOTUNE="1" if arm == "autotune"
                              else "0", TPUDL_DEVICE_MS_PER_STEP=device_ms):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    y = run()
                    torch.cuda.synchronize()
                    rates[arm].append(len(frame) / (time.perf_counter()
                                                    - t0))
                rep = last_pipeline_report()
                equal.append(bool(np.array_equal(y, y0)))
                if arm == "autotune":
                    seeds.append({k: rep[k] for k in rep["autotuned"]})
        counts[f"obs_autotune_{what.split()[0].lower()}"] = dict(
            cuda_ops.launch_counts)
        ok = all(equal) and rep["autotune"] is True
        print(f"  {what}: autotune seeds by window {seeds}; "
              + "; ".join(f"{arm} median {median(r):.1f} {unit} (least "
                          f"{min(r):.1f}, most {max(r):.1f})"
                          for arm, r in rates.items())
              + f" over {OBS_WINDOWS} windows an arm in turn; outputs bit "
              f"for bit: {all(equal)}; {'ok' if ok else 'MISS'}; card {card}",
              flush=True)
        if not ok:
            problems.append(f"autotune {what}")
        del stage
    torch.cuda.empty_cache()
    return counts


def obs_stall_leg(tmp, card, problems):
    """A stage whose prepare sleeps past ``TPUDL_WATCHDOG_STALL_S`` on the
    card (in a child, whose process-wide counters hold no other run's
    decode errors or rejects): one stall event, and
    ``python -m tpudl_torch.obs doctor`` classifies its dump
    ``infeed_stall``."""
    from tpudl_torch import obs
    from tpudl_torch.frame import Frame
    from tpudl_torch.obs import flight, watchdog

    d = os.path.join(tmp, "stall")

    def pack(col):
        if int(col[0]) == 8:
            time.sleep(OBS_STALL_SLEEP_S)
        return np.asarray(col, dtype=np.float32)[:, None]

    before = obs.counter("obs.watchdog.stalls").value
    with env_vars(TPUDL_FLIGHT_DIR=d, TPUDL_WATCHDOG_STALL_S=OBS_STALL_S):
        watchdog.stop_watchdog()       # the next heartbeat starts it anew
        flight.get_recorder().reset()
        try:
            out = Frame({"x": np.arange(24)}).map_batches(
                lambda t: t * 2, ["x"], ["y"], batch_size=8, pack=pack,
                prefetch_depth=1, prepare_workers=1, dispatch_depth=1)
        finally:
            watchdog.stop_watchdog()
        stalls = flight.get_recorder().snapshot()["stalls"]
        flight.dump(reason="manual")
    n = obs.counter("obs.watchdog.stalls").value - before
    rows_ok = bool(np.array_equal(np.stack(list(out["y"])).ravel(),
                                  2 * np.arange(24, dtype=np.float32)))
    res = subprocess.run([sys.executable, "-m", "tpudl_torch.obs", "doctor",
                          d], capture_output=True, text=True, timeout=120,
                         cwd=REPO_DIR, env=dict(
                             os.environ, PYTHONPATH=REPO_DIR + os.pathsep
                             + os.environ.get("PYTHONPATH", "")))
    diag = next((ln for ln in res.stdout.splitlines()
                 if ln.startswith("DIAGNOSIS")), res.stderr[-300:])
    ok = (len(stalls) == 1 and n == 1 and rows_ok and res.returncode == 0
          and "infeed_stall" in diag)
    print(f"  stall: prepare slept {OBS_STALL_SLEEP_S} s under "
          f"TPUDL_WATCHDOG_STALL_S={OBS_STALL_S}: {len(stalls)} stall "
          f"event(s) (obs.watchdog.stalls +{n:.0f}), in flight "
          f"{[list(st['in_flight']) for st in stalls]}; `python -m "
          f"tpudl_torch.obs doctor` rc {res.returncode}: {diag}; "
          f"{'ok' if ok else 'MISS'}; card {card}", flush=True)
    if not ok:
        problems.append("stall -> infeed_stall")


def obs_serve_leg(spec, weights, tmp, card, problems):
    """Phase 15's engine behind a ``Server`` under
    ``run_closed_loop(tenant=("a", "b"))``: the SLO gauges, each
    tenant's completions and tokens, the ledger reconciled exactly, and
    ``obs top --once`` rendered."""
    import io

    from tpudl_torch import cuda_ops, obs
    from tpudl_torch.obs import live, slo
    from tpudl_torch.serve import (ModelRegistry, RequestQueue, Server,
                                   run_closed_loop)

    slo.reset_slo_engine()
    reg = ModelRegistry()
    entry = reg.add_model("lm", spec, weights, slots=SERVE_SLOTS,
                          cache_len=SERVE_CACHE, warm=True)
    before = obs.ledger_snapshot()["scopes"]
    prompts = serve_prompts([16 + 15 * i for i in range(OBS_SERVE_REQUESTS)],
                            SEED + 22)
    srv = Server(reg, RequestQueue(cap=64)).start_async()
    reset_launch_counts()
    try:
        out = run_closed_loop(srv, lambda i: prompts[i],
                              requests=OBS_SERVE_REQUESTS,
                              clients=OBS_SERVE_CLIENTS,
                              max_new=OBS_SERVE_NEW, model="lm",
                              timeout=SERVE_TIMEOUT,
                              tenant=("phase20-a", "phase20-b"))
    finally:
        srv.close(timeout=SERVE_TIMEOUT)
    launches = dict(cuda_ops.launch_counts)
    view = slo.get_slo_engine().publish(force=True)
    gauges = {n.split("serve.slo.")[1]: round(v["value"], 3)
              for n, v in obs.snapshot(prefix="serve.slo.").items()
              if v.get("value") is not None}
    rows = obs.ledger_snapshot()["scopes"]
    done = {t: rows[f"tenant={t}"]["serve_completed"]
            - before.get(f"tenant={t}", {}).get("serve_completed", 0)
            for t in ("phase20-a", "phase20-b")}
    rec = obs.reconcile()
    d = os.path.join(tmp, "top")
    live.write_status(d)
    frame = io.StringIO()
    rc = live.top_main(d, once=True, out=frame)
    ok = (out["completed"] == OBS_SERVE_REQUESTS and rec["ok"]
          and sum(done.values()) == OBS_SERVE_REQUESTS
          and min(done.values()) >= 1 and rc == 0
          and view["window_n"] >= OBS_SERVE_REQUESTS)
    print(f"  serve: {OBS_SERVE_REQUESTS} requests, {OBS_SERVE_CLIENTS} "
          f"clients over two tenants: qps {out['qps']}, p50 {out['p50_ms']} "
          f"ms, p99 {out['p99_ms']} ms; serve.slo.* {gauges}; completions "
          f"by tenant {done}; ledger reconciled: {rec['ok']}; flash "
          f"launches {launches}; {'ok' if ok else 'MISS'}; card {card}",
          flush=True)
    print("  obs top --once:")
    for line in frame.getvalue().splitlines():
        print(f"    {line}")
    if not ok:
        problems.append("serve tenants / SLO / ledger")
    del reg, entry, srv
    torch.cuda.empty_cache()
    return launches


def obs_overhead_leg(spec, weights, tmp, card, problems):
    """tracer + watchdog + status writer + scope armed against unarmed,
    on ``LMFeaturizer`` and InceptionV3 bf16 fused, ``OBS_OVERHEAD_ROUNDS``
    windows an arm in turn (each window one untimed run, then the timed
    one, so every arm's timed run follows a run): median and spread of each
    arm and its ratio to the unarmed arm (tpudl's contract is under 5%; a
    reading over it is reported, not hidden). The executor's spans,
    heartbeats and ledger charges run in both arms: ``--parent-overhead``
    holds the unarmed arm against the tree before them."""
    from tpudl_torch import obs
    from tpudl_torch.frame import Frame
    from tpudl_torch.ml import DeepImageFeaturizer, LMFeaturizer
    from tpudl_torch.obs import live, watchdog
    from tpudl_torch.text import ByteTokenizer

    everything = ("watchdog", "status", "scope")
    cases = {
        "LMFeaturizer": (
            LMFeaturizer(inputCol="text", outputCol="y", model=spec,
                         weights=weights, tokenizer=ByteTokenizer(),
                         batchSize=BATCH),
            Frame({"text": make_texts(OBS_TEXTS, SEED + 20)}),
            {"unarmed": (), "armed": everything}),
        "InceptionV3 bf16 fused": (
            DeepImageFeaturizer(inputCol="image", outputCol="y",
                                modelName="InceptionV3",
                                computeDtype="bfloat16",
                                batchSize=IMAGE_BATCH, fuseSteps=EXEC_FUSE),
            Frame({"image": image_structs(OBS_IMAGE_ROWS, (299, 299, 3),
                                          SEED + 21)}),
            {"unarmed": (), "armed": everything})}
    status = os.path.join(tmp, "overhead-status")
    ratios = {}
    for what, (stage, frame, arms) in cases.items():
        def run():
            stage.transform(frame)
            torch.cuda.synchronize()

        run()
        run()
        secs = {arm: [] for arm in arms}
        for _ in range(OBS_OVERHEAD_ROUNDS):
            for arm, parts in arms.items():
                if "watchdog" in parts:
                    obs.start_watchdog(stall_s=30.0)
                if "status" in parts:
                    if os.path.exists(live.status_path(status)):
                        os.remove(live.status_path(status))
                    live.start_status_writer(status, 1.0)
                    # its first frame is written at its start
                    while not os.path.exists(live.status_path(status)):
                        time.sleep(0.01)
                ctx = (obs.scope(tenant="phase20-overhead")
                       if "scope" in parts else contextlib.nullcontext())
                try:
                    with ctx:
                        run()                       # untimed
                        t0 = time.perf_counter()
                        run()
                        secs[arm].append(time.perf_counter() - t0)
                finally:
                    watchdog.stop_watchdog()
                    live.stop_status_writer()
        base = median(secs["unarmed"])
        ratios[what] = {arm: median(v) / base for arm, v in secs.items()
                        if arm != "unarmed"}
        print(f"  overhead {what}: "
              + "; ".join(f"{arm} median {1e3 * median(v):.1f} ms (least "
                          f"{1e3 * min(v):.1f}, most {1e3 * max(v):.1f})"
                          + ("" if arm == "unarmed" else
                             f", x{median(v) / base:.4f}")
                          for arm, v in secs.items())
              + f" over {OBS_OVERHEAD_ROUNDS} windows an arm in turn; "
              f"armed/unarmed "
              f"{ratios[what]['armed']:.4f} ("
              f"{'within' if ratios[what]['armed'] <= 1.05 else 'OVER'} "
              f"tpudl's 5%); card {card}", flush=True)
    torch.cuda.empty_cache()
    return ratios


def obs_stall_child(tmp):
    """Phase 20's stall leg in a fresh process: the doctor classifies a
    dump by the process-wide counters in it, and the main process holds
    the decode errors and rejects of phases 6-19. Prints the leg's lines,
    then one JSON line of its problems."""
    problems = []
    obs_stall_leg(tmp, card_line(), problems)
    print(json.dumps({"obs_child": {}, "problems": problems}))


def obs_stall_in_child(tmp, problems):
    """Run :func:`obs_stall_child` in a child process; its lines go to
    this log, its problems to this phase."""
    res = subprocess.run(
        [sys.executable, os.path.join(REPO_DIR, "chip_smoke.py"),
         "--obs-stall-child", tmp], capture_output=True, text=True,
        timeout=300, cwd=REPO_DIR, env=dict(
            os.environ, PYTHONPATH=REPO_DIR + os.pathsep
            + os.environ.get("PYTHONPATH", "")))
    got = None
    for line in res.stdout.splitlines():
        if line.startswith('{"obs_child"'):
            got = json.loads(line)
        elif not line.startswith("card:"):
            print(line, flush=True)
    if res.returncode != 0 or got is None:
        print(res.stderr[-3000:])
        problems.append(f"the stall leg's child (rc {res.returncode})")
        return
    problems.extend(got["problems"])


# phase 20's studies: where a capture's lost device events go, and the
# executor's always-on instrumentation against the tree before it
STUDY_SESSIONS = 60                # profiler sessions of each kind a trigger
STUDY_TEXTS = 16                   # one LMFeaturizer batch a session


def raw_capture_stats(path):
    """Of a raw torch.profiler export: its device events and marker
    kernels, the runtime launches and those whose kernel is missing from
    the device lanes, and the least and median (kernel start - launch
    start) in µs over the launches whose kernel is there."""
    from tpudl_torch.obs import trace as T

    events = T.load_host_trace_events(path)
    dev = T.device_events(events)
    by_corr = {(e.get("args") or {}).get("correlation"): e for e in dev}
    launches = [e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "Launch" in str(e.get("name", ""))]
    corr = [(e, (e.get("args") or {}).get("correlation")) for e in launches]
    orphans = [e for e, c in corr if c not in by_corr]
    skews = sorted(float(by_corr[c]["ts"]) - float(e["ts"])
                   for e, c in corr if c in by_corr)
    return {"device": len(dev),
            "markers": sum(T.MARK_KERNEL in e["name"] for e in dev),
            "launches": len(launches),
            "launches_without_kernel": len(orphans),
            "orphans_first_ts_rank": (sorted(float(e["ts"])
                                             for e in launches).index(
                float(orphans[0]["ts"])) if orphans else None),
            "min_kernel_minus_launch_us": (round(skews[0], 1)
                                           if skews else None),
            "median_kernel_minus_launch_us": (round(median(skews), 1)
                                              if skews else None)}


def profile_study(card):
    """Where a capture's lost device events go: phase 20's profiled
    ``LMFeaturizer`` (64 texts, 12 flash launches a batch) under
    ``obs.profile`` in a fresh process, then again after each of these
    triggers: ``STUDY_SESSIONS`` torch.profiler sessions tracing the card
    alone (as phases 6-19's idle shares do), the host alone, and both;
    sessions that start and stop while another thread keeps launching;
    a CUDA graph captured under the profiler. Each capture prints the
    flash kernels on its device lanes against the launch counter, its
    marker record, and the raw export's launches without a kernel and
    clock skew (:func:`raw_capture_stats`)."""
    import tempfile
    import threading

    from torch.profiler import ProfilerActivity, profile

    from tpudl_torch import cuda_ops, obs
    from tpudl_torch.frame import Frame
    from tpudl_torch.ml import LMFeaturizer
    from tpudl_torch.obs import trace as T
    from tpudl_torch.text import ByteTokenizer
    from tpudl_torch.zoo.transformer import TinyCausalLM

    spec = TinyCausalLM(VOCAB, DIM, HEADS, LAYERS, MAX_LEN, device="meta")
    st = LMFeaturizer(inputCol="text", outputCol="vec", model=spec,
                      weights=spec.init(SEED), tokenizer=ByteTokenizer(),
                      batchSize=BATCH)
    frame = Frame({"text": make_texts(OBS_TEXTS, SEED + 20)})
    small = Frame({"text": make_texts(STUDY_TEXTS, SEED + 23)})
    st.transform(frame)                       # loads and warms
    want = LAYERS * -(-OBS_TEXTS // BATCH)
    failures = []

    def one(fn):
        fn()
        torch.cuda.synchronize()

    def capture(tag, tmp):
        d = os.path.join(tmp, tag)
        reset_launch_counts()
        with obs.profile(d) as prof:
            st.transform(frame)
        launches = cuda_ops.launch_counts["flash_attn_fwd"]
        raw = os.path.join(d, "raw.json")
        try:
            prof.export_chrome_trace(raw)
            stats = raw_capture_stats(raw)
        except Exception as e:                # noqa: BLE001 - report it
            stats = f"raw export failed: {e!r}"
        named = obs_kernel_events(T.load_trace_events(d))
        ok = named["flash_attn_fwd"] == launches == want
        print(f"  study capture after {tag}: flash forward "
              f"{named['flash_attn_fwd']} kernel events, launch counter "
              f"{launches} (want {want}); capture {prof.capture}; raw "
              f"export {stats}; process age "
              f"{time.perf_counter() - T_START:.0f} s; "
              f"{'ok' if ok else 'MISS'}; card {card}", flush=True)
        if not ok or prof.capture["truncated"]:
            failures.append(tag)

    def sessions(acts, n=STUDY_SESSIONS):
        for _ in range(n):
            with profile(activities=acts):
                one(lambda: st.transform(small))

    def with_launcher(fn):
        stop = threading.Event()
        x = torch.randn(512, 512, device="cuda")

        def launch():
            while not stop.is_set():
                for _ in range(16):
                    x.mul_(0.5).add_(0.5)
                time.sleep(0.001)

        th = threading.Thread(target=launch, daemon=True)
        th.start()
        try:
            fn()
        finally:
            stop.set()
            th.join()
            torch.cuda.synchronize()

    def graph_under_profiler():
        x = torch.randn(256, 256, device="cuda")
        g = torch.cuda.CUDAGraph()
        s_ = torch.cuda.Stream()
        s_.wait_stream(torch.cuda.current_stream())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            with torch.cuda.stream(s_):
                y = x @ x
                torch.cuda.synchronize()
                with torch.cuda.graph(g):
                    y = x @ x + 1
            torch.cuda.current_stream().wait_stream(s_)
            for _ in range(8):
                g.replay()
            torch.cuda.synchronize()
        del y, g

    CPU, CUDA = ProfilerActivity.CPU, ProfilerActivity.CUDA
    with tempfile.TemporaryDirectory(prefix="tpudl-study-") as tmp:
        capture("a fresh start", tmp)
        capture("one capture", tmp)
        for tag, trigger in (
                (f"{STUDY_SESSIONS} card-only sessions",
                 lambda: sessions([CUDA])),
                (f"{STUDY_SESSIONS} host-only sessions",
                 lambda: sessions([CPU])),
                (f"{STUDY_SESSIONS} host+card sessions",
                 lambda: sessions([CPU, CUDA])),
                ("20 card-only sessions beside a launching thread",
                 lambda: with_launcher(lambda: sessions([CUDA], 20))),
                ("a CUDA graph captured under the profiler",
                 graph_under_profiler),
                ("one capture beside a launching thread", lambda: None)):
            t0 = time.perf_counter()
            if tag.startswith("one capture beside"):
                with_launcher(lambda: capture(tag, tmp))
                continue
            try:
                trigger()
            except Exception as e:            # noqa: BLE001 - report it
                print(f"  trigger {tag} raised {e!r}", flush=True)
            print(f"  trigger {tag}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
            capture(tag, tmp)
    print(f"  profile study: captures that lost the block's events or "
          f"were truncated: {failures or 'none'}; card {card}", flush=True)


HEAD_PAUSE_S = 0.02                # the bisect's second capture: host pause
# where --head-bisect's probe rows and its children's logs go
HEAD_OUT = os.environ.get("CHIP_SMOKE_OUT",
                          os.path.join(REPO_DIR, "chip_smoke_out"))
HEAD_CLOCK_AGES = {"every": (0, 100, 200, 400, 600, 800),
                   "late": (800, 820)}  # child ages (s) of a probe capture


class HeadProbe:
    """The head-loss bisect's probe: one ``LMFeaturizer`` batch (16 texts,
    12 flash launches) at phase 4's width under three marked captures —
    one through ``obs.profile`` as every reading takes it, two by hand
    that synchronize first, the second also pausing the host
    ``HEAD_PAUSE_S`` after the profiler starts and before its markers —
    with each capture's marker record and its launches without a kernel
    and least (kernel start - launch start)."""

    def __init__(self, card):
        from tpudl_torch.frame import Frame
        from tpudl_torch.ml import LMFeaturizer
        from tpudl_torch.text import ByteTokenizer
        from tpudl_torch.zoo.transformer import TinyCausalLM

        spec = TinyCausalLM(VOCAB, DIM, HEADS, LAYERS, MAX_LEN, device="meta")
        self.stage = LMFeaturizer(inputCol="text", outputCol="vec",
                                  model=spec, weights=spec.init(SEED),
                                  tokenizer=ByteTokenizer(),
                                  batchSize=BATCH)
        self.frame = Frame({"text": make_texts(STUDY_TEXTS, SEED + 23)})
        self.card = card
        self.rows = []
        os.makedirs(HEAD_OUT, exist_ok=True)

    def _paused(self, d, pause_s):
        """A marked capture as ``obs.profile`` takes it, after a
        synchronize, with the host paused ``pause_s`` between the
        profiler's start and the head markers."""
        from torch.profiler import ProfilerActivity, profile

        from tpudl_torch.obs import trace as T

        os.makedirs(d, exist_ok=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pause_s)
            T._launch_marks(T.HEAD_MARKS)
            self.stage.transform(self.frame)
            torch.cuda.synchronize()
            T._launch_marks(1, T.TAIL_CYCLES)
        raw = os.path.join(d, "paused.json")
        prof.export_chrome_trace(raw)
        _, cap = T.account_marks(T.load_host_trace_events(raw), T.HEAD_MARKS)
        return cap, raw_capture_stats(raw)

    def __call__(self, tag):
        import tempfile

        from tpudl_torch import cuda_ops, obs

        counts = dict(cuda_ops.launch_counts)       # the phases' own counts
        self.stage.transform(self.frame)            # loads and warms
        torch.cuda.synchronize()
        from tpudl_torch.obs import trace as T

        with tempfile.TemporaryDirectory(prefix="tpudl-head-") as tmp:
            try:
                with obs.profile(os.path.join(tmp, "marked")) as prof:
                    self.stage.transform(self.frame)
            except T.TruncatedCapture:
                pass                  # recorded: prof.capture says so
            # the saved trace: its block's kernels and launches (a trace
            # exports once; the markers are out of it)
            stats = raw_capture_stats(prof.trace_path)
            synced, synced_stats = self._paused(
                os.path.join(tmp, "synced"), 0.0)
            paused, paused_stats = self._paused(
                os.path.join(tmp, "paused"), HEAD_PAUSE_S)
        cuda_ops.launch_counts.update(counts)
        cap = prof.capture
        age = time.perf_counter() - T_START
        self.rows.append((tag, round(age), cap["head_lost"],
                          cap["launches_without_kernel"],
                          stats["min_kernel_minus_launch_us"],
                          synced["head_lost"],
                          synced_stats["min_kernel_minus_launch_us"],
                          paused["head_lost"],
                          paused["launches_without_kernel"],
                          paused_stats["min_kernel_minus_launch_us"]))
        with open(os.path.join(HEAD_OUT, f"head-bisect-{os.getpid()}.txt"),
                  "a") as f:
            f.write(repr(self.rows[-1]) + "\n")
        print(f"  head probe after {tag}: process age {age:.0f} s; "
              f"obs.profile: head_lost {cap['head_lost']}, "
              f"launches_without_kernel {cap['launches_without_kernel']}, "
              f"truncated {cap['truncated']}, block {stats}; synced "
              f"first: head_lost {synced['head_lost']}, raw "
              f"{synced_stats}; synced and paused "
              f"{HEAD_PAUSE_S * 1e3:.0f} ms after start: head_lost "
              f"{paused['head_lost']}, launches_without_kernel "
              f"{paused['launches_without_kernel']}, raw {paused_stats}; "
              f"card {self.card}", flush=True)

    def table(self):
        print("  head-loss bisect (tag, age s; obs.profile: head_lost, "
              "launches_without_kernel, min kernel-launch us; synced: "
              "head_lost, min kernel-launch us; synced and paused: "
              "head_lost, launches_without_kernel, min kernel-launch us):",
              flush=True)
        for row in self.rows:
            print(f"    {row}", flush=True)


def head_clock_child(mode):
    """A process that runs nothing but the head probe, at the ages
    ``HEAD_CLOCK_AGES[mode]`` of its own clock, idle between: whether a
    capture's head loss grows with the process's age alone."""
    probe = HeadProbe(card_line())
    t0 = time.perf_counter()
    for age in HEAD_CLOCK_AGES[mode]:
        time.sleep(max(0.0, age - (time.perf_counter() - t0)))
        probe(f"{mode} child at {age} s")
    probe.table()


def start_clock_children():
    """Start the bisect's two idle children; their output goes under
    ``HEAD_OUT`` (``$CHIP_SMOKE_OUT``, default ``chip_smoke_out/``)."""
    out = HEAD_OUT
    os.makedirs(out, exist_ok=True)
    kids = []
    for mode in HEAD_CLOCK_AGES:
        log = open(os.path.join(out, f"head-clock-{mode}.log"), "w")
        kids.append((mode, log, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--head-clock-child",
             mode], stdout=log, stderr=subprocess.STDOUT, cwd=REPO_DIR)))
    atexit.register(lambda: [p.kill() for _, _, p in kids
                             if p.poll() is None])
    return kids


def finish_clock_children(kids):
    for mode, log, p in kids:
        try:
            rc = p.wait(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = p.wait()
        log.close()
        with open(log.name) as f:
            tail = [ln for ln in f if "head probe" in ln or "    (" in ln]
        print(f"  head clock child {mode}: rc {rc}", flush=True)
        for ln in tail:
            print("  " + ln.rstrip(), flush=True)


# phase 21: the analyzers, the lock sanitizer, the capture-storm sentinel
# and the debug hooks (tpudl_torch.analysis, testing.tsan/traceck, debug)
ANALYSIS_FUSE = 4                  # the armed LMFeaturizer's fused arm
ANALYSIS_STORM_CALLS = 5           # fresh closures through the store
ANALYSIS_STORM = 3                 # TPUDL_TRACECK_STORM of the storm child
ANALYSIS_CK_SEQ = 1024             # the checkify leg's tokens a row
ANALYSIS_CHILD_TIMEOUT = 600
ANALYSIS_CHILDREN = ("storm", "deadlock", "checkify", "armed")
ANALYSIS_ENV = {
    "armed": {"TPUDL_TSAN": "1", "TPUDL_TRACECK": "1"},
    "storm": {"TPUDL_TRACECK": "1",
              "TPUDL_TRACECK_STORM": str(ANALYSIS_STORM)},
    "deadlock": {"TPUDL_TSAN": "1", "TPUDL_TSAN_DEADLOCK_S": "0.5"},
    "checkify": {},
}


def analysis_lm_stage(spec, weights, **kw):
    from tpudl_torch.ml import LMFeaturizer
    from tpudl_torch.text import ByteTokenizer

    return LMFeaturizer(inputCol="text", outputCol="vec", model=spec,
                        weights=weights, tokenizer=ByteTokenizer(),
                        batchSize=BATCH, **kw)


def analysis_armed_child(tmp):
    """Under ``TPUDL_TSAN=1 TPUDL_TRACECK=1``: phase 4's ``LMFeaturizer``
    over 64 texts eager and fused through the store, phase 15's engine
    behind a supervised ``Server``, one phase-4b step plain and one under
    ``debug_nans``; writes ``armed.json``."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.debug import debug_nans
    from tpudl_torch.frame import Frame
    from tpudl_torch.serve import ModelRegistry, RequestQueue, Server
    from tpudl_torch.testing import traceck, tsan
    from tpudl_torch.train import Trainer, adamw
    from tpudl_torch.zoo.transformer import TinyCausalLM, load_jax_params

    out = {"tsan": tsan.enabled(), "traceck": traceck.installed()}
    want = np.load(os.path.join(tmp, "features.npy"))
    spec = TinyCausalLM(VOCAB, DIM, HEADS, LAYERS, MAX_LEN, device="meta")
    weights = spec.init(SEED)
    frame = Frame({"text": make_texts(OBS_TEXTS, SEED + 20)})
    for arm, kw in (("eager", {}), ("fused", {"fuseSteps": ANALYSIS_FUSE})):
        with aot_env(os.path.join(tmp, "store") if kw else None):
            st = analysis_lm_stage(spec, weights, **kw)
            st.transform(frame)               # loads, warms, captures
            reset_launch_counts()
            y = np.stack(list(st.transform(frame)["vec"]))
            out[f"lm_{arm}"] = {"bitwise": bool(np.array_equal(y, want)),
                                "launches": dict(cuda_ops.launch_counts)}
        del st
    reg = ModelRegistry()
    entry = reg.add_model("lm", spec, weights, slots=SERVE_SLOTS,
                          cache_len=SERVE_CACHE, warm=True)
    prompts = serve_prompts(SERVE_PARITY_PLENS, SEED)
    srv = Server(reg, RequestQueue(cap=64), supervise=True)
    reqs = [srv.submit(p, SERVE_MAX_NEW, model="lm") for p in prompts]
    srv._stop.set()
    summary = srv.run()
    streams = [np.asarray(r.result(timeout=SERVE_TIMEOUT)) for r in reqs]
    serial = [serve_serial(entry.engine.model, p, SERVE_MAX_NEW)
              for p in prompts]
    out["serve"] = {"completed": summary["completed"],
                    "equal": [bool(np.array_equal(a, b))
                              for a, b in zip(streams, serial)]}
    del reg, entry, srv
    torch.cuda.empty_cache()
    rows = training_rows(TRAIN_BATCH)
    for arm in ("plain", "debug_nans"):
        lm = TinyCausalLM(**TRAIN_ARCH, device="cuda")
        load_jax_params(lm, lm.init(SEED))
        reset_launch_counts()
        with (debug_nans() if arm == "debug_nans"
              else contextlib.nullcontext()):
            _, _, hist = Trainer(lm.loss_fn(), adamw(LR), log_every=1).fit(
                lm, lambda s: rows, 1)
        torch.cuda.synchronize()
        out[f"train_{arm}"] = {"loss": hist[0]["loss"],
                               "launches": dict(cuda_ops.launch_counts)}
        del lm
    out["anomaly_after"] = torch.is_anomaly_enabled()
    rep = tsan.report()
    out["tsan"] = {"findings": rep["findings"],
                   "hold_times": rep["hold_times"],
                   "locks_seen": rep["locks_seen"]}
    out["traceck"] = {"counts": traceck.counts(),
                      "findings": traceck.findings()}
    with open(os.path.join(tmp, "armed.json"), "w") as f:
        json.dump(out, f)


def analysis_storm_child(tmp):
    """Under ``TPUDL_TRACECK=1 TPUDL_TRACECK_STORM=3``: a fresh closure
    through the program store ``ANALYSIS_STORM_CALLS`` times (a capture
    each), then a flight dump into ``tmp/storm``; writes ``storm.json``."""
    from tpudl_torch.compile.store import ProgramStore
    from tpudl_torch.obs import flight
    from tpudl_torch.testing import traceck

    store = ProgramStore(os.path.join(tmp, "storm-store"))
    x = torch.randn(256, 256, device="cuda")
    for k in range(ANALYSIS_STORM_CALLS):
        store.call(lambda t, k=k: t @ t + k, (x,))
    torch.cuda.synchronize()
    os.makedirs(os.path.join(tmp, "storm"), exist_ok=True)
    path = flight.dump(reason="storm", path=os.path.join(
        tmp, "storm", f"tpudl-dump-{os.getpid()}.json.gz"))
    with open(os.path.join(tmp, "storm.json"), "w") as f:
        json.dump({"installed": traceck.installed(),
                   "counts": traceck.counts(),
                   "findings": traceck.findings(), "dump": path}, f)


def analysis_deadlock_child(tmp):
    """Under ``TPUDL_TSAN=1 TPUDL_TSAN_DEADLOCK_S=0.5``: two threads take
    two named locks in opposite orders; exits 3 when the sanitizer
    reported the deadlock (its report lands in ``TPUDL_FLIGHT_DIR``)."""
    import threading

    from tpudl_torch.testing import tsan

    a = tsan.named_lock("phase21.abba.a")
    b = tsan.named_lock("phase21.abba.b")
    barrier = threading.Barrier(2)

    def take(first, second):
        with first:
            barrier.wait()
            with second:
                pass

    threads = [threading.Thread(target=take, args=p)
               for p in ((a, b), (b, a))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    tsan.write_report()
    dead = [f for f in tsan.findings() if f["kind"] == "deadlock"]
    sys.exit(3 if dead and not any(th.is_alive() for th in threads) else 1)


def analysis_checkify_child(tmp):
    """``checkify_fn`` around phase 4's embedding function (``hidden`` and
    a mean over the sequence) captured through the program store: a
    clean replay, a NaN written into the embedding table the graph reads,
    an out-of-range token id; writes ``checkify.json``."""
    from tpudl_torch import cuda_ops
    from tpudl_torch.compile.store import ProgramStore
    from tpudl_torch.debug import NaNError, OOBError, checkify_fn
    from tpudl_torch.device import full_f32
    from tpudl_torch.zoo.transformer import TinyCausalLM, load_jax_params

    lm = TinyCausalLM(VOCAB, DIM, HEADS, LAYERS, MAX_LEN, device="cuda")
    load_jax_params(lm, lm.init(SEED))
    checked = checkify_fn(lambda tokens: lm.hidden(tokens).mean(dim=1))
    store = ProgramStore(os.path.join(tmp, "ck-store"))
    rng = np.random.default_rng(SEED + 21)
    tokens = torch.from_numpy(rng.integers(
        1, VOCAB, (BATCH, ANALYSIS_CK_SEQ)).astype(np.int64)).cuda()
    out = {}

    def caught(fn, kind):
        try:
            fn()
        except kind as e:
            return str(e)
        return None

    def flagged(args, kind):
        """Where a call through the store raised ``kind``: at the call
        (an eager run), or at the check after a replay."""
        try:
            store.call(checked, args)
        except kind as e:
            return ["call", str(e)]
        try:
            checked.check()
        except kind as e:
            return ["replay", str(e)]
        return None

    with torch.inference_mode(), full_f32():
        eager = checked(tokens)
        reset_launch_counts()
        store.call(checked, (tokens,))           # a miss: eager, captured
        replay = store.call(checked, (tokens,))  # a hit: the replay
        checked.check()
        torch.cuda.synchronize()
        out["launches"] = dict(cuda_ops.launch_counts)
        out["clean_bitwise"] = bool(torch.equal(replay, eager))
        out["programs"] = store.programs()
        table = lm.embed["table"]
        row = int(tokens[0, 0])
        saved = table[row].clone()
        table[row, 0] = float("nan")
        out["nan"] = flagged((tokens,), NaNError)
        table[row] = saved
        bad = tokens.clone()
        bad[0, 5] = VOCAB + 7
        out["oob_eager"] = caught(lambda: checked(bad), OOBError)
        out["oob_replay"] = flagged((bad,), OOBError)
        torch.cuda.synchronize()                 # no device-side assert
        again = store.call(checked, (tokens,))
        checked.check()
        out["after_bitwise"] = bool(torch.equal(again, eager))
    with open(os.path.join(tmp, "checkify.json"), "w") as f:
        json.dump(out, f)


def analysis_child(kind, tmp):
    {"armed": analysis_armed_child, "storm": analysis_storm_child,
     "deadlock": analysis_deadlock_child,
     "checkify": analysis_checkify_child}[kind](tmp)


def start_analysis_child(kind, tmp):
    env = dict(os.environ, TPUDL_FLIGHT_DIR=os.path.join(tmp, kind),
               **ANALYSIS_ENV[kind])
    os.makedirs(env["TPUDL_FLIGHT_DIR"], exist_ok=True)
    log = open(os.path.join(tmp, f"{kind}.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--analysis-child", kind,
         tmp], stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO_DIR)
    return proc, log, time.perf_counter()


def finish_analysis_child(kind, child, tmp, problems):
    proc, log, t0 = child
    try:
        rc = proc.wait(timeout=ANALYSIS_CHILD_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    log.close()
    text = open(log.name).read()
    print(f"  {kind} child: rc {rc} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    want_rc = 3 if kind == "deadlock" else 0
    if rc != want_rc:
        print("\n".join("    " + ln for ln in text.splitlines()[-25:]),
              flush=True)
        problems.append(f"{kind} child exited {rc} (want {want_rc})")
        return None, text
    path = os.path.join(tmp, f"{kind}.json")
    return (json.load(open(path)) if os.path.exists(path) else {}), text


def analysis_gate(card, problems):
    """``python -m tpudl_torch.analysis --json tpudl_torch``: rc 0, no
    finding."""
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "tpudl_torch.analysis",
                          "--json", "tpudl_torch"], capture_output=True,
                         text=True, cwd=REPO_DIR, timeout=300)
    dt = time.perf_counter() - t0
    try:
        doc = json.loads(run.stdout)
    except ValueError:
        doc = {"files": 0, "findings": ["unreadable output"], "errors": []}
    ok = run.returncode == 0 and not doc["findings"] and not doc["errors"]
    print(f"  the gate: python -m tpudl_torch.analysis tpudl_torch: rc "
          f"{run.returncode}, {doc['files']} files, {len(doc['findings'])} "
          f"finding(s), {len(doc['errors'])} error(s) in {dt:.1f} s; "
          f"{'ok' if ok else 'MISS'}", flush=True)
    if not ok:
        print(run.stderr[-3000:], flush=True)
        problems.append("the gate")


def analysis_check_armed(res, card, problems):
    if res is None:
        return {}
    want = LAYERS * -(-OBS_TEXTS // BATCH)
    ok_lm = all(res[f"lm_{arm}"]["bitwise"] and
                res[f"lm_{arm}"]["launches"]["flash_attn_fwd"] == want
                for arm in ("eager", "fused"))
    print(f"  armed LMFeaturizer over {OBS_TEXTS} texts: eager "
          f"{res['lm_eager']}, fused (fuseSteps={ANALYSIS_FUSE}, aot) "
          f"{res['lm_fused']} (want {want} forward launches, features bit "
          f"for bit the unarmed parent's); {'ok' if ok_lm else 'MISS'}; "
          f"card {card}", flush=True)
    srv = res["serve"]
    ok_srv = all(srv["equal"]) and srv["completed"] == len(srv["equal"])
    print(f"  armed supervised Server: {srv['completed']} greedy requests, "
          f"streams equal to serial generate {srv['equal']}; "
          f"{'ok' if ok_srv else 'MISS'}", flush=True)
    plain, dn = res["train_plain"], res["train_debug_nans"]
    layers = TRAIN_ARCH["layers"]
    ok_tr = (dn["loss"] == plain["loss"] and not res["anomaly_after"]
             and all(dn["launches"][k] == layers
                     for k in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv")))
    print(f"  one phase-4b step under debug_nans: loss {dn['loss']!r} "
          f"against the plain step's {plain['loss']!r} (bit for bit: "
          f"{dn['loss'] == plain['loss']}), launches {dn['launches']} (want "
          f"{layers} of each backward kernel), anomaly mode off after: "
          f"{not res['anomaly_after']}; {'ok' if ok_tr else 'MISS'}; card "
          f"{card}", flush=True)
    kinds = [f["kind"] for f in res["tsan"]["findings"]]
    storms = res["traceck"]["findings"]
    ok_rep = (res["tsan"].get("findings") == [] and storms == []
              and res["traceck"]["counts"])
    holds = sorted(res["tsan"]["hold_times"].items(),
                   key=lambda kv: -kv[1]["max_s"])
    print(f"  armed report: tsan findings {kinds or 'none'} "
          f"(inversions, deadlocks, lockset, declared-order: "
          f"{sum(k == 'inversion' for k in kinds)}, "
          f"{sum(k == 'deadlock' for k in kinds)}, "
          f"{sum(k == 'lockset' for k in kinds)}, "
          f"{sum(k == 'declared-order' for k in kinds)}); "
          f"{len(res['tsan']['locks_seen'])} named locks seen; "
          f"traceck storms {len(storms)}; {'ok' if ok_rep else 'MISS'}",
          flush=True)
    print("  hold times (max s, total s, acquisitions), longest first: "
          + "; ".join(f"{k} {v['max_s']:.6f} {v['total_s']:.6f} {v['n']}"
                      for k, v in holds[:12]), flush=True)
    print("  captures per identity: " + "; ".join(
        f"{os.path.relpath(k.split(':')[0], REPO_DIR)}:"
        f"{':'.join(k.split(':')[1:])} x{n}"
        for k, n in sorted(res["traceck"]["counts"].items())), flush=True)
    for what, ok in (("armed LMFeaturizer", ok_lm),
                     ("armed serving", ok_srv),
                     ("debug_nans training step", ok_tr),
                     ("armed report", ok_rep)):
        if not ok:
            problems.append(what)
    return {"analysis_armed_lm": res["lm_fused"]["launches"],
            "analysis_debug_nans_training": dn["launches"]}


def analysis_check_storm(res, tmp, card, problems):
    if res is None:
        return
    doc = subprocess.run([sys.executable, "-m", "tpudl_torch.obs", "doctor",
                          os.path.join(tmp, "storm")], capture_output=True,
                         text=True, cwd=REPO_DIR, timeout=120)
    counts = sorted(res["counts"].values())
    ok = (res["installed"] and len(res["findings"]) == 1
          and counts == [ANALYSIS_STORM_CALLS] and doc.returncode == 0
          and "recompile_storm" in doc.stdout)
    print(f"  storm child: {ANALYSIS_STORM_CALLS} fresh closures through the "
          f"store, captures per identity {counts}, storm findings "
          f"{res['findings']}; python -m tpudl_torch.obs doctor rc "
          f"{doc.returncode}, says recompile_storm: "
          f"{'recompile_storm' in doc.stdout}; {'ok' if ok else 'MISS'}",
          flush=True)
    if not ok:
        print(doc.stdout[-2000:] + doc.stderr[-2000:], flush=True)
        problems.append("storm child")


def analysis_check_deadlock(res, text, tmp, problems):
    reports = sorted(glob.glob(os.path.join(tmp, "deadlock",
                                            "tpudl-tsan-*.json")))
    dead = []
    if reports:
        rep = json.load(open(reports[-1]))
        dead = [f for f in rep["findings"] if f["kind"] == "deadlock"]
    ok = (res is not None and "DeadlockError" in text and dead
          and set(dead[0]["locks"]) == {"phase21.abba.a", "phase21.abba.b"})
    print(f"  deadlock child: DeadlockError raised: {'DeadlockError' in text};"
          f" report {os.path.basename(reports[-1]) if reports else None} "
          f"names {dead[0]['locks'] if dead else None}; "
          f"{'ok' if ok else 'MISS'}", flush=True)
    if not ok:
        problems.append("deadlock child")


def analysis_check_checkify(res, card, problems):
    if res is None:
        return {}
    ok = (res["clean_bitwise"] and res["after_bitwise"]
          and res["launches"]["flash_attn_fwd"] == 2 * LAYERS
          and res["oob_eager"]
          and all(res[k] and res[k][0] == "replay"
                  for k in ("nan", "oob_replay")))
    print(f"  checkify child: the embed function through the store "
          f"({res['programs']} program), clean replay bit for bit: "
          f"{res['clean_bitwise']}; launches {res['launches']} (want "
          f"{2 * LAYERS} forward: the miss's eager run and one replay); NaN "
          f"in the table on replay: {res['nan']!r}; out-of-range token "
          f"eager: {res['oob_eager']!r}, on replay: {res['oob_replay']!r}; "
          f"synchronize then a clean replay bit for bit: "
          f"{res['after_bitwise']}; {'ok' if ok else 'MISS'}; card {card}",
          flush=True)
    if not ok:
        problems.append("checkify child")
    return {"analysis_checkify_embed": res["launches"]}


def run_analysis(card):
    """Phase 21: the gate on this machine, then four children started
    together — the storm, the deadlock and the checkify legs at once, the
    armed leg once this process has the unarmed features it is held to.
    Every check runs and prints; the phase fails at its end if any did
    not hold. Returns the kernel launches of its paths."""
    import tempfile

    from tpudl_torch.frame import Frame
    from tpudl_torch.zoo.transformer import TinyCausalLM

    t_phase = time.perf_counter()
    problems = []
    with tempfile.TemporaryDirectory(prefix="tpudl-analysis-") as tmp:
        kids = {kind: start_analysis_child(kind, tmp)
                for kind in ANALYSIS_CHILDREN if kind != "armed"}
        spec = TinyCausalLM(VOCAB, DIM, HEADS, LAYERS, MAX_LEN,
                            device="meta")
        st = analysis_lm_stage(spec, spec.init(SEED))
        frame = Frame({"text": make_texts(OBS_TEXTS, SEED + 20)})
        np.save(os.path.join(tmp, "features.npy"),
                np.stack(list(st.transform(frame)["vec"])))
        del st
        torch.cuda.empty_cache()
        kids["armed"] = start_analysis_child("armed", tmp)
        analysis_gate(card, problems)
        results = {kind: finish_analysis_child(kind, kids[kind], tmp,
                                               problems)
                   for kind in ANALYSIS_CHILDREN}
        counts = analysis_check_armed(results["armed"][0], card, problems)
        analysis_check_storm(results["storm"][0], tmp, card, problems)
        analysis_check_deadlock(results["deadlock"][0],
                                results["deadlock"][1], tmp, problems)
        counts.update(analysis_check_checkify(results["checkify"][0], card,
                                              problems))
    print(f"  phase 21: {time.perf_counter() - t_phase:.1f} s; card {card}",
          flush=True)
    if problems:
        fail("phase 21: " + "; ".join(problems))
    return counts


UNARMED_CHILD_ROUNDS = 3           # timed runs a stage in each child


def unarmed_child(tree):
    """In a process importing ``tpudl_torch`` from ``tree``: the overhead
    leg's unarmed arm (``LMFeaturizer`` over 64 texts, InceptionV3 bf16
    fused over 512 structs), two warm runs, then ``UNARMED_CHILD_ROUNDS``
    rounds of an untimed and a timed run of each stage in turn. Prints
    one JSON line of seconds by stage."""
    sys.path.insert(0, os.path.abspath(tree))
    import tpudl_torch
    from tpudl_torch.frame import Frame
    from tpudl_torch.ml import DeepImageFeaturizer, LMFeaturizer
    from tpudl_torch.text import ByteTokenizer
    from tpudl_torch.zoo.transformer import TinyCausalLM

    spec = TinyCausalLM(VOCAB, DIM, HEADS, LAYERS, MAX_LEN, device="meta")
    cases = {
        "LMFeaturizer": (
            LMFeaturizer(inputCol="text", outputCol="y", model=spec,
                         weights=spec.init(SEED), tokenizer=ByteTokenizer(),
                         batchSize=BATCH),
            Frame({"text": make_texts(OBS_TEXTS, SEED + 20)})),
        "InceptionV3 bf16 fused": (
            DeepImageFeaturizer(inputCol="image", outputCol="y",
                                modelName="InceptionV3",
                                computeDtype="bfloat16",
                                batchSize=IMAGE_BATCH, fuseSteps=EXEC_FUSE),
            Frame({"image": image_structs(OBS_IMAGE_ROWS, (299, 299, 3),
                                          SEED + 21)}))}

    def run(stage, frame):
        stage.transform(frame)
        torch.cuda.synchronize()

    for stage, frame in cases.values():
        run(stage, frame)
        run(stage, frame)
    secs = {what: [] for what in cases}
    for _ in range(UNARMED_CHILD_ROUNDS):
        for what, (stage, frame) in cases.items():
            run(stage, frame)                    # untimed
            t0 = time.perf_counter()
            run(stage, frame)
            secs[what].append(time.perf_counter() - t0)
    print(json.dumps({"unarmed": secs,
                      "package": os.path.dirname(tpudl_torch.__file__)}))


def parent_overhead(tree, card):
    """The unarmed arm of the overhead leg on the tree before this
    package's always-on instrumentation (``tree``, a checkout of it) and
    on this one, one child process each in the order parent, this, this,
    parent: the median seconds of each stage by tree and their ratio."""
    runs = []
    for who in ("parent", "this", "this", "parent"):
        pkg = os.path.abspath(tree) if who == "parent" else REPO_DIR
        res = subprocess.run(
            [sys.executable, os.path.join(REPO_DIR, "chip_smoke.py"),
             "--unarmed-child", pkg], capture_output=True, text=True,
            timeout=400, cwd=REPO_DIR)
        got = next((json.loads(ln) for ln in res.stdout.splitlines()
                    if ln.startswith('{"unarmed"')), None)
        if res.returncode or got is None:
            print(res.stdout[-2000:], res.stderr[-3000:])
            fail(f"the unarmed child on {who} ({pkg}): rc {res.returncode}")
        print(f"  unarmed child on {who} (tpudl_torch from {got['package']}):"
              + "; ".join(f" {what} " + ", ".join(f"{1e3 * t:.1f}"
                                                   for t in ts) + " ms"
                          for what, ts in got["unarmed"].items())
              + f"; card {card}", flush=True)
        runs.append((who, got["unarmed"]))
    for what in runs[0][1]:
        by = {who: [t for w, r in runs if w == who for t in r[what]]
              for who in ("parent", "this")}
        print(f"  {what} unarmed: parent median {1e3 * median(by['parent']):.1f}"
              f" ms (least {1e3 * min(by['parent']):.1f}, most "
              f"{1e3 * max(by['parent']):.1f}), this tree median "
              f"{1e3 * median(by['this']):.1f} ms (least "
              f"{1e3 * min(by['this']):.1f}, most "
              f"{1e3 * max(by['this']):.1f}), this/parent "
              f"x{median(by['this']) / median(by['parent']):.4f} over "
              f"{len(by['this'])} timed runs a tree; card {card}",
              flush=True)


def run_obs(card):
    """Phase 20: the rest of observability at phase 4's width. Every check
    runs and prints; the phase fails at its end if any did not hold.
    Returns the kernel launches of its paths."""
    import tempfile

    from tpudl_torch.zoo.transformer import TinyCausalLM

    t_phase = time.perf_counter()
    problems = []
    counts = {}
    spec = TinyCausalLM(VOCAB, DIM, HEADS, LAYERS, MAX_LEN, device="meta")
    weights = spec.init(SEED)
    with tempfile.TemporaryDirectory(prefix="tpudl-obs-") as tmp:
        for name, leg in (
                ("obs_timeline_leg", lambda: counts.update(
                    obs_timeline_leg(spec, weights, tmp, card, problems))),
                ("obs_training_leg", lambda: counts.update(
                    obs_training_step=obs_training_leg(tmp, card,
                                                       problems))),
                ("obs_stall_leg (a child)", lambda: obs_stall_in_child(
                    tmp, problems)),
                ("obs_autotune_leg", lambda: counts.update(
                    obs_autotune_leg(spec, weights, card, problems))),
                ("obs_serve_leg", lambda: counts.update(
                    obs_serve_tenants=obs_serve_leg(spec, weights, tmp,
                                                    card, problems))),
                ("obs_overhead_leg", lambda: obs_overhead_leg(
                    spec, weights, tmp, card, problems))):
            t0 = time.perf_counter()
            leg()
            print(f"  {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    print(f"  phase 20: {time.perf_counter() - t_phase:.1f} s; card {card}")
    if problems:
        fail("phase 20: " + "; ".join(problems))
    return counts


def main(argv) -> int:
    # a cold-start child's clock starts at its process start: no nvidia-smi
    card = ("" if argv[:1] in (["--compile-child"], ["--jobs-child"],
                               ["--obs-stall-child"], ["--unarmed-child"],
                               ["--analysis-child"])
            else card_line())
    print(f"card: {card}", flush=True)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this script measures "
             "the port on an NVIDIA GPU and has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # phases 1-19 keep their arms' meaning: the executor's autotune (on by
    # default) stays off there; phase 20 arms it where it measures it
    os.environ["TPUDL_FRAME_AUTOTUNE"] = "0"
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}) on "
          f"{torch.cuda.get_device_name(0)}; TF32 off for matmul and cuDNN "
          "(f32 products run in full f32)", flush=True)
    bisect = argv == ["--head-bisect"]   # the whole path, probed a phase
    if bisect:
        argv = []
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
    if argv == ["--keras2-only"]:
        print(f"phase 12 alone: the Keras files at full width on {card}",
              flush=True)
        run_keras2_files(card)
        print(f"card: {card}")
        print(f"keras2-only run: every check passed in "
              f"{time.perf_counter() - T_START:.1f} s")
        return 0
    if argv == ["--data-only"]:
        print(f"phase 13 alone: the data layer at full width on {card}",
              flush=True)
        run_data_layer(card)
        print(f"card: {card}")
        print(f"data-only run: every check passed in "
              f"{time.perf_counter() - T_START:.1f} s")
        return 0
    if argv == ["--mesh-only"]:
        print(f"phase 14 alone: the data-parallel mesh at full width on "
              f"{card}", flush=True)
        run_mesh(card)
        print(f"card: {card}")
        print(f"mesh-only run: every check passed in "
              f"{time.perf_counter() - T_START:.1f} s")
        return 0
    if argv == ["--serve-only"]:
        print(f"phase 15 alone: serving at full width on {card}", flush=True)
        run_serve(card)
        print(f"card: {card}")
        print(f"serve-only run: every check passed in "
              f"{time.perf_counter() - T_START:.1f} s")
        return 0
    if argv == ["--parallel-only"]:
        print(f"phase 16 alone: LM parallelism at full width on {card}",
              flush=True)
        run_parallel(card)
        print(f"card: {card}")
        print(f"parallel-only run: every check passed in "
              f"{time.perf_counter() - T_START:.1f} s")
        return 0
    if argv == ["--compile-only"]:
        print(f"phase 17 alone: the compile subsystem at full width on "
              f"{card}", flush=True)
        run_compile(card)
        print(f"card: {card}")
        print(f"compile-only run: every check passed in "
              f"{time.perf_counter() - T_START:.1f} s")
        return 0
    if argv == ["--group-only"]:
        print(f"phases 16 and 18 alone: the model axis, local and over a "
              f"process group, at full width on {card}", flush=True)
        run_parallel(card)
        print(f"phase 18: the model axis over a process group on {card}",
              flush=True)
        run_group(card)
        print(f"card: {card}")
        print(f"group-only run: every check passed in "
              f"{time.perf_counter() - T_START:.1f} s")
        return 0
    if argv == ["--jobs-only"]:
        print(f"phase 19 alone: jobs, faults and the supervisor at full "
              f"width on {card}", flush=True)
        run_jobs(card)
        print(f"card: {card}")
        print(f"jobs-only run: every check passed in "
              f"{time.perf_counter() - T_START:.1f} s")
        return 0
    if argv == ["--obs-only"]:
        print(f"phase 20 alone: the rest of observability at full width on "
              f"{card}", flush=True)
        run_obs(card)
        print(f"card: {card}")
        print(f"obs-only run: every check passed in "
              f"{time.perf_counter() - T_START:.1f} s")
        return 0
    if argv == ["--analysis-only"]:
        from tpudl_torch import _build

        _build.build()
        print(f"phase 21: the analyzers, the sanitizer, the sentinel and "
              f"the debug hooks on {card}", flush=True)
        run_analysis(card)
        print(f"card: {card}")
        print(f"chip_smoke.py --analysis-only: every check passed in "
              f"{time.perf_counter() - T_START:.1f} s")
        return 0
    if argv == ["--profile-study"]:
        print(f"the profiler capture study on {card}", flush=True)
        profile_study(card)
        print(f"card: {card}")
        print(f"profile study: done in "
              f"{time.perf_counter() - T_START:.1f} s")
        return 0
    if len(argv) == 2 and argv[0] == "--parent-overhead":
        print(f"the executor's always-on instrumentation against "
              f"{argv[1]} on {card}", flush=True)
        parent_overhead(argv[1], card)
        print(f"card: {card}")
        print(f"parent overhead: done in "
              f"{time.perf_counter() - T_START:.1f} s")
        return 0
    if len(argv) == 2 and argv[0] == "--unarmed-child":
        unarmed_child(argv[1])            # --parent-overhead's child
        return 0
    if len(argv) == 3 and argv[0] == "--analysis-child":
        analysis_child(argv[1], argv[2])  # phase 21's children
        return 0
    if len(argv) == 2 and argv[0] == "--head-clock-child":
        head_clock_child(argv[1])         # --head-bisect's idle children
        return 0
    if len(argv) == 2 and argv[0] == "--obs-stall-child":
        obs_stall_child(argv[1])          # phase 20's stall leg
        return 0
    if len(argv) == 3 and argv[0] == "--compile-child":
        compile_child(argv[1], argv[2])   # phase 17's cold-start child
        return 0
    if len(argv) == 3 and argv[0] == "--jobs-child":
        jobs_child(argv[1], argv[2])      # phase 19's job attempt
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
             "--graph-only, --keras2-only, --data-only, --mesh-only, "
             "--serve-only, --parallel-only, --compile-only, --group-only, "
             "--jobs-only, --obs-only, --analysis-only, --ranks N, "
             "--pool-study, --profile-study, --head-bisect and "
             "--parent-overhead TREE")

    from tpudl_torch import _build

    print("phase 2: build", flush=True)
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"  built {sorted(logs) or 'nothing (cached)'} from "
          f"{_build.CSRC} in {time.perf_counter() - t0:.1f} s")
    check_ptxas(logs)
    kids = start_clock_children() if bisect else []

    print("phase 3: kernels vs their plain versions", flush=True)
    slice_err = check_flash()
    bwd_err = check_flash_bwd()

    print(f"phase 4: serving slice at full width on {card}", flush=True)
    launches = run_slice()

    probe = HeadProbe(card) if bisect else (lambda tag: None)
    probe("phase 4")
    print(f"phase 4b: training slice at full width on {card}", flush=True)
    train_counts = run_training()
    probe("phase 4b")

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
    probe("phase 6")
    print(f"phase 7: the executor at full width on {card}", flush=True)
    fwd_entry["launches_by_path"]["executor"] = run_executor(card)
    probe("phase 7")
    print(f"phase 8: ResNet50 training through HorovodRunner on {card}",
          flush=True)
    resnet_counts = run_resnet_training(card)
    probe("phase 8")
    print(f"phase 9: the Keras surface at full width on {card}", flush=True)
    keras_counts = run_keras_surface(card)
    probe("phase 9")
    print(f"phase 10: model selection and SQL UDFs at full width on {card}",
          flush=True)
    surface_counts = run_surface(card)
    probe("phase 10")
    print(f"phase 11: TF graph ingestion at full width on {card}",
          flush=True)
    graph_counts = run_graph_ingest(card)
    probe("phase 11")
    print(f"phase 12: the Keras files at full width on {card}", flush=True)
    keras2_counts = run_keras2_files(card)
    probe("phase 12")
    print(f"phase 13: the data layer at full width on {card}", flush=True)
    data_counts = run_data_layer(card)
    probe("phase 13")
    print(f"phase 14: the data-parallel mesh at full width on {card}",
          flush=True)
    mesh_counts = run_mesh(card)
    probe("phase 14")
    print(f"phase 15: serving at full width on {card}", flush=True)
    serve_counts = run_serve(card)
    probe("phase 15")
    print(f"phase 16: LM parallelism at full width on {card}", flush=True)
    parallel_counts = run_parallel(card)
    probe("phase 16")
    print(f"phase 17: the compile subsystem at full width on {card}",
          flush=True)
    compile_counts_ = run_compile(card)
    probe("phase 17")
    print(f"phase 18: the model axis over a process group on {card}",
          flush=True)
    group_counts = run_group(card)
    probe("phase 18")
    print(f"phase 19: jobs, faults and the supervisor at full width on "
          f"{card}", flush=True)
    jobs_counts = run_jobs(card)
    probe("phase 19")
    print(f"phase 20: the rest of observability at full width on {card}",
          flush=True)
    obs_counts = run_obs(card)
    probe("phase 20")
    print(f"phase 21: the analyzers, the sanitizer, the sentinel and the "
          f"debug hooks on {card}", flush=True)
    analysis_counts = run_analysis(card)
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
        entry["launches_by_path"]["keras2_files"] = \
            keras2_counts[entry["name"]]
        for path, counts in {**data_counts, **mesh_counts,
                             **serve_counts, **parallel_counts,
                             **compile_counts_, **group_counts,
                             **jobs_counts, **obs_counts,
                             **analysis_counts}.items():
            entry["launches_by_path"][path] = counts[entry["name"]]
    if bisect:
        probe.table()
        finish_clock_children(kids)
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
