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
   at the training shape; print one ``{"kernels": [...]}`` line.

The last line is ``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

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


def main() -> int:
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
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
