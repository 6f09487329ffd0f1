"""LM transformers over string columns — the text stages of the port.

Port of ``tpudl/ml/lm.py``, with the same constructor names plus
``device=`` (default ``"cuda"``):

- :class:`LMFeaturizer` — string column → mean-pooled final-norm hidden
  states (``TinyCausalLM.hidden``, whose attention runs the flash kernel);
- :class:`LMClassifier` — string column → label string: last-real-position
  logits (``TinyCausalLM.apply``) gathered at each class's leading token
  id;
- :class:`LMGenerator` — string column → completion string (KV-cache
  ``generate``), cut at the first EOS.

``model=`` names the architecture (a :class:`~tpudl_torch.zoo.transformer.
TinyCausalLM`, or anything with its ``vocab``/``dim``/``heads``/``layers``
/``max_len``; build it on ``device="meta"`` to allocate nothing) and
``weights=`` is tpudl's numpy param pytree: the stage loads it into a
module on its own device once and reuses it while ``weights`` is the same
object. ``tokenizer=`` is a :mod:`tpudl_torch.text` tokenizer. The
executor knobs of tpudl's stages (``mesh``, ``tp``, ``prefetchDepth``,
``prepareWorkers``, ``fuseSteps``, ``dispatchDepth``, ``cacheDir``,
``deviceCache``, a codec given by name) are not ported yet and raise.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudl_torch.compile.buckets import resolve_ladder
from tpudl_torch.data.codec import WireCodec
from tpudl_torch.ml.params import HasInputCol, HasOutputCol, keyword_only
from tpudl_torch.ml.pipeline import Transformer
from tpudl_torch.obs import metrics as _obs_metrics
from tpudl_torch.text.codec import TokenCodec, pad_mask, tokenize_pack
from tpudl_torch.text.tokenizer import EOS_ID
from tpudl_torch.zoo.transformer import TinyCausalLM

__all__ = ["LMFeaturizer", "LMGenerator", "LMClassifier"]

_LM_ATTRS = ("model", "weights", "tokenizer", "maxLen", "maxNew",
             "temperature", "seed", "classes", "promptBuckets",
             "batchSize", "device")
# tpudl stage knobs with no counterpart yet → the ROADMAP Queue 1 item
_NOT_PORTED = {"mesh": "Executor", "tp": "LM parallelism",
               "prefetchDepth": "Executor", "prepareWorkers": "Executor",
               "fuseSteps": "Executor", "dispatchDepth": "Executor",
               "cacheDir": "Executor", "deviceCache": "Executor"}


class _LMStage(Transformer, HasInputCol, HasOutputCol):
    """Shared constructor plumbing: model/tokenizer/geometry are plain
    attributes, only inputCol/outputCol go through ``_set``."""

    def _init_lm(self):
        kwargs = dict(self._input_kwargs)
        for k, item in _NOT_PORTED.items():
            if kwargs.pop(k, None) not in (None, False):
                raise NotImplementedError(
                    f"{type(self).__name__}({k}=...) is not ported to "
                    f"tpudl_torch yet (ROADMAP Queue 1, {item!r})")
        codec = kwargs.pop("wireCodec", None)
        if codec is not None and not isinstance(codec, WireCodec):
            raise NotImplementedError(
                f"wireCodec={codec!r}: codecs by name are not ported yet "
                "(ROADMAP Queue 1, 'Executor'); pass a WireCodec")
        self.wireCodec = codec
        for k in _LM_ATTRS:
            kwargs.pop(k, None)
        self._set(**kwargs)
        self._loaded = None  # (weights, device, module) of the last load

    def _require(self):
        missing = [k for k in ("model", "weights", "tokenizer")
                   if getattr(self, k, None) is None]
        if missing:
            raise ValueError(
                f"{type(self).__name__} needs {missing} — pass the "
                "TinyCausalLM (model=), its param pytree (weights=), and "
                "a tpudl_torch.text Tokenizer (tokenizer=)")
        if self._loaded is None or self._loaded[0] is not self.weights \
                or self._loaded[1] != self.device:
            m = self.model
            net = TinyCausalLM.from_jax_params(
                self.weights, vocab=m.vocab, dim=m.dim, heads=m.heads,
                layers=m.layers, max_len=m.max_len, device=self.device)
            self._loaded = (self.weights, self.device, net)
        return self._loaded[2], self.tokenizer

    def _codec(self):
        return self.wireCodec or TokenCodec(
            vocab_size=self.tokenizer.vocab_size)


class LMFeaturizer(_LMStage):
    """String column → pooled hidden-state feature vectors ``[dim]``."""

    @keyword_only
    def __init__(self, *, inputCol=None, outputCol=None, model=None,
                 weights=None, tokenizer=None, maxLen=None,
                 promptBuckets="pow2", batchSize=32, device="cuda",
                 mesh=None, tp=False, prefetchDepth=None,
                 prepareWorkers=None, fuseSteps=None, dispatchDepth=None,
                 wireCodec=None, cacheDir=None, deviceCache=None):
        super().__init__()
        self.model = model
        self.weights = weights
        self.tokenizer = tokenizer
        self.maxLen = maxLen
        self.promptBuckets = promptBuckets
        self.batchSize = int(batchSize)
        self.device = device
        self._init_lm()

    def _transform(self, frame):
        net, tok = self._require()
        pack = tokenize_pack(tok, seq_len=self.maxLen,
                             buckets=self.promptBuckets, bos=True)

        def fn(tokens):
            mask = pad_mask(tokens)                        # [B, S]
            h = net.hidden(tokens)
            pooled = (h * mask[..., None]).sum(dim=1)
            return pooled / mask.sum(dim=1, keepdim=True).clamp_min(1.0)

        with torch.inference_mode():
            out = frame.map_batches(
                fn, [self.getInputCol()], [self.getOutputCol()],
                batch_size=self.batchSize, pack=pack,
                wire_codec=self._codec(), device=self.device)
        _obs_metrics.counter("lm.embed.rows").inc(len(frame))
        return out


class LMClassifier(_LMStage):
    """String column → label string: last-real-position logits gathered
    at each class's LEADING token id (classes must start with distinct
    tokens under the tokenizer — checked)."""

    @keyword_only
    def __init__(self, *, inputCol=None, outputCol=None, model=None,
                 weights=None, tokenizer=None, classes=None, maxLen=None,
                 promptBuckets="pow2", batchSize=32, device="cuda",
                 mesh=None, tp=False, prefetchDepth=None,
                 prepareWorkers=None, fuseSteps=None, dispatchDepth=None,
                 wireCodec=None, cacheDir=None, deviceCache=None):
        super().__init__()
        self.model = model
        self.weights = weights
        self.tokenizer = tokenizer
        self.classes = list(classes) if classes else None
        self.maxLen = maxLen
        self.promptBuckets = promptBuckets
        self.batchSize = int(batchSize)
        self.device = device
        self._init_lm()

    def _class_ids(self, tok) -> list:
        if not self.classes:
            raise ValueError("LMClassifier needs classes=[...] (label "
                             "strings)")
        ids = []
        for c in self.classes:
            enc = tok.encode(c)
            if enc.size == 0:
                raise ValueError(f"class {c!r} tokenizes to nothing "
                                 f"under {tok!r}")
            ids.append(int(enc[0]))
        if len(set(ids)) != len(ids):
            raise ValueError(
                f"classes {self.classes} do not start with distinct "
                f"token ids under {tok!r} (leading ids {ids}); pick "
                "distinguishable label strings")
        return ids

    def _transform(self, frame):
        net, tok = self._require()
        class_ids = torch.tensor(self._class_ids(tok), device=net.device)
        pack = tokenize_pack(tok, seq_len=self.maxLen,
                             buckets=self.promptBuckets, bos=True)

        def fn(tokens):
            mask = pad_mask(tokens)
            logits = net.apply(tokens)                     # [B, S, vocab]
            last = (mask.sum(dim=1).to(torch.int64) - 1).clamp_min(0)
            row = logits[torch.arange(tokens.shape[0], device=net.device),
                         last]
            return row[:, class_ids].argmax(dim=-1).to(torch.int32)

        out_col = self.getOutputCol()
        with torch.inference_mode():
            out = frame.map_batches(
                fn, [self.getInputCol()], [out_col],
                batch_size=self.batchSize, pack=pack,
                wire_codec=self._codec(), device=self.device)
        labels = np.array(self.classes, dtype=object)[
            np.asarray(out[out_col], dtype=np.int64)]
        _obs_metrics.counter("lm.classify.rows").inc(len(frame))
        return out.drop(out_col).with_column(out_col, list(labels))


class LMGenerator(_LMStage):
    """String column → generated completion string (decoded, cut at the
    first EOS). Rows group by exact prompt length and run in chunks of
    ``batchSize``; each ``generate`` call sizes its KV cache from the
    prompt's ``promptBuckets`` rung, as in tpudl. tpudl also pads each
    chunk to a batch rung to bound its compiled programs; eager torch
    compiles nothing per shape, and rows are independent in decode, so
    chunks run at their real size."""

    @keyword_only
    def __init__(self, *, inputCol=None, outputCol=None, model=None,
                 weights=None, tokenizer=None, maxNew=16,
                 temperature=0.0, seed=0, promptBuckets="pow2",
                 batchSize=8, device="cuda", mesh=None, tp=False):
        super().__init__()
        self.model = model
        self.weights = weights
        self.tokenizer = tokenizer
        self.maxNew = int(maxNew)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.promptBuckets = promptBuckets
        self.batchSize = max(1, int(batchSize))
        self.device = device
        self._init_lm()

    def _transform(self, frame):
        net, tok = self._require()
        texts = list(frame[self.getInputCol()])
        # bos=True guarantees every prompt holds >= 1 token
        prompts = tok.encode_batch(texts, bos=True)
        ladder = resolve_ladder(
            self.promptBuckets if self.promptBuckets is not None
            else "pow2")
        groups: dict = {}
        for i, p in enumerate(prompts):
            groups.setdefault(len(p), []).append(i)
        out_rows: list = [None] * len(texts)
        n_new = 0
        for plen in sorted(groups):
            idxs = groups[plen]
            for c0 in range(0, len(idxs), self.batchSize):
                chunk = idxs[c0:c0 + self.batchSize]
                gen = None
                if self.temperature > 0:
                    # one stream per chunk, seeded from (seed, plen, c0)
                    # as tpudl folds its key, so chunks are independent
                    gen = torch.Generator(device=net.device)
                    gen.manual_seed(self.seed * 1_000_003 + plen * 8191 + c0)
                toks = net.generate(
                    np.stack([prompts[i] for i in chunk]), self.maxNew,
                    temperature=self.temperature, generator=gen,
                    prompt_buckets=ladder).cpu().numpy()
                for row, i in zip(toks, chunk):
                    stop = np.flatnonzero(row == EOS_ID)
                    if stop.size:
                        row = row[: stop[0]]
                    out_rows[i] = row
                    n_new += int(row.size)
        _obs_metrics.counter("lm.generate.requests").inc(len(texts))
        _obs_metrics.counter("lm.generate.tokens").inc(n_new)
        completions = [tok.decode(r) for r in out_rows]
        return frame.with_column(self.getOutputCol(), completions)
