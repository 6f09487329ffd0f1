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
featurizer and the classifier run through ``Frame.map_batches`` with the
executor knobs ``prefetchDepth``, ``prepareWorkers``, ``fuseSteps`` and
``dispatchDepth``; their per-batch function is built once per loaded
model and configuration, so that a fused CUDA graph cached on it serves
every later ``transform``. The data layer's knobs pass through as in
tpudl: ``wireCodec`` (default a ``TokenCodec`` over the tokenizer's
vocab; ``"tokens"`` by name), ``cacheDir`` (a warm run tokenizes nothing:
the pack's ``cache_token`` carries the tokenizer's fingerprint) and
``deviceCache``. ``mesh`` (a local :class:`~tpudl_torch.mesh.Mesh`)
runs the featurizer and the classifier data-parallel over its data axis:
without ``tp`` (tpudl's ``mesh`` without ``tp`` only shards the batch)
the module loads on the mesh's first card, is replicated to the other
rows' first cards once, and each row's shard of a batch runs the dense
forward on its replica, the flash kernel in every block on every card.
With ``tp=True`` (tpudl's ``_hidden_mesh``) each data row's module is
laid out over that row's model-axis cards (``shard_params``) and its
shard runs tensor-parallel there; the generator then decodes
tensor-parallel over the first row. Without ``tp`` the generator runs on
the mesh's first card.

The model is float32, and each stage computes its products in full f32
whatever TF32 setting the process holds (``device.full_f32``), as tpudl
computes them.

With the program store armed (``TPUDL_COMPILE_AOT``) the featurizer's and
the classifier's per-batch functions dispatch through it (one CUDA graph
a batch shape; the flash forward's 12 launches are counted at every
replay), keyed across processes by an ``aot_token`` of the stage, the
architecture and a content hash of ``weights`` taken on the host; the
generator's greedy ``generate`` calls run one graph a (chunk, prompt
rung) geometry.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudl_torch.compile.buckets import resolve_ladder
from tpudl_torch.device import full_f32
from tpudl_torch.ml.params import (EXECUTOR_KNOBS, HasInputCol,
                                   HasOutputCol, keyword_only,
                                   refuse_unported)
from tpudl_torch.ml.pipeline import Transformer
from tpudl_torch.obs import metrics as _obs_metrics
from tpudl_torch.text.codec import TokenCodec, pad_mask, tokenize_pack
from tpudl_torch.text.tokenizer import EOS_ID
from tpudl_torch.zoo.transformer import TinyCausalLM, arch_of

__all__ = ["LMFeaturizer", "LMGenerator", "LMClassifier"]

_LM_ATTRS = ("model", "weights", "tokenizer", "maxLen", "maxNew",
             "temperature", "seed", "classes", "promptBuckets",
             "batchSize", "device", "tp")


class _LMStage(Transformer, HasInputCol, HasOutputCol):
    """Shared constructor plumbing: model/tokenizer/geometry are plain
    attributes, only inputCol/outputCol go through ``_set``."""

    def _init_lm(self):
        kwargs = dict(self._input_kwargs)
        refuse_unported(type(self).__name__, kwargs, EXECUTOR_KNOBS)
        self._set_pipeline_opts(kwargs)
        for k in _LM_ATTRS:
            kwargs.pop(k, None)
        self._set(**kwargs)
        self._loaded = None  # (weights, device, module) of the last load
        self._tp_nets: dict = {}  # row's first card → its laid-out module
        self._weights_token = None  # content identity of the loaded weights

    def _require(self):
        missing = [k for k in ("model", "weights", "tokenizer")
                   if getattr(self, k, None) is None]
        if missing:
            raise ValueError(
                f"{type(self).__name__} needs {missing} — pass the "
                "TinyCausalLM (model=), its param pytree (weights=), and "
                "a tpudl_torch.text Tokenizer (tokenizer=)")
        home = self._home_device()
        if self._loaded is None or self._loaded[0] is not self.weights \
                or self._loaded[1] != home:
            self._tp_nets = {}
            net = (self._tp_net(home) if self.tp else
                   TinyCausalLM.from_jax_params(
                       self.weights, **arch_of(self.model), device=home))
            self._loaded = (self.weights, home, net)
            from tpudl_torch.compile.store import content_token

            self._weights_token = content_token(self.weights)
        return self._loaded[2], self.tokenizer

    def _replica(self, net, device):
        """``net`` on ``device``: itself without a mesh, else that card's
        replica (made once); under ``tp`` the module of the data row that
        starts at ``device``, laid out over the row's cards."""
        if self.tp:
            return self._tp_net(device)
        if self.mesh is None:
            return net
        from tpudl_torch import mesh as M

        return M.replicate(net, self.mesh)[torch.device(device)]

    def _row_mesh(self, device):
        """The data row of ``self.mesh`` whose first card is ``device``."""
        if self.mesh is None:
            raise ValueError(
                "tp=True needs a mesh with a 'model' axis "
                "(tpudl_torch.mesh.build_mesh(n_data=..., n_model=..., "
                "devices=[...]))")
        dev = torch.device(device)
        return self.mesh.row(next(r for r, row in enumerate(self.mesh.grid)
                                  if row[0] == dev))

    def _tp_net(self, device):
        """Under ``tp``: the module of the data row starting at ``device``,
        loaded there and laid out over the row (made once)."""
        dev = torch.device(device)
        net = self._tp_nets.get(dev)
        if net is None:
            net = TinyCausalLM.from_jax_params(
                self.weights, **arch_of(self.model), device=dev)
            net = self._tp_nets[dev] = net.shard_params(self._row_mesh(dev))
        return net

    def _forward_kw(self, device) -> dict:
        """What the forward of the row at ``device`` takes: its row mesh
        under ``tp``, nothing otherwise."""
        return dict(mesh=self._row_mesh(device), tp=True) if self.tp else {}

    def _codec_opts(self) -> dict:
        opts = self._pipeline_opts()
        if opts.get("wire_codec") is None:
            opts["wire_codec"] = TokenCodec(
                vocab_size=self.tokenizer.vocab_size)
        return opts

    def _fn_key(self, net, *extra) -> tuple:
        """What a per-batch function closes over: the loaded module, the
        stage's geometry, and ``extra``."""
        return (id(net), self.maxLen, self.promptBuckets, self.tp, *extra)

    def _aot_token(self, net, *extra) -> str | None:
        """The program store's identity of a per-batch function: the
        stage, the architecture, the weights' content (hashed on the host
        at load) and ``extra``; None when the weights have none."""
        if self._weights_token is None:
            return None
        return (f"{type(self).__name__}:{net.aot_token}:"
                f"w{self._weights_token}:tp{self.tp}:{extra!r}")


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
        self.tp = bool(tp)
        self._init_lm()

    def _transform(self, frame):
        net, tok = self._require()
        pack = tokenize_pack(tok, seq_len=self.maxLen,
                             buckets=self.promptBuckets, bos=True)

        def build(device):
            lm = self._replica(net, device)
            kw = self._forward_kw(device)

            def fn(tokens):
                mask = pad_mask(tokens)                    # [B, S]
                h = lm.hidden(tokens, **kw)
                pooled = (h * mask[..., None]).sum(dim=1)
                return pooled / mask.sum(dim=1, keepdim=True).clamp_min(1.0)
            fn.aot_token = self._aot_token(net, "featurize")
            return fn

        fn = self._device_fn(self._fn_key(net, "featurize"), build)
        with torch.inference_mode(), full_f32():
            out = frame.map_batches(
                fn, [self.getInputCol()], [self.getOutputCol()],
                batch_size=self.batchSize, pack=pack, device=self.device,
                **self._codec_opts())
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
        self.tp = bool(tp)
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
        ids = tuple(self._class_ids(tok))
        pack = tokenize_pack(tok, seq_len=self.maxLen,
                             buckets=self.promptBuckets, bos=True)

        def build(device):
            lm = self._replica(net, device)
            kw = self._forward_kw(device)
            class_ids = torch.tensor(ids, device=lm.device)

            def fn(tokens):
                mask = pad_mask(tokens)
                logits = lm.apply(tokens, **kw)            # [B, S, vocab]
                last = (mask.sum(dim=1).to(torch.int64) - 1).clamp_min(0)
                row = logits[torch.arange(tokens.shape[0],
                                          device=lm.device), last]
                return row[:, class_ids].argmax(dim=-1).to(torch.int32)
            fn.aot_token = self._aot_token(net, "classify", ids)
            return fn

        fn = self._device_fn(self._fn_key(net, "classify", ids), build)
        out_col = self.getOutputCol()
        with torch.inference_mode(), full_f32():
            out = frame.map_batches(
                fn, [self.getInputCol()], [out_col],
                batch_size=self.batchSize, pack=pack, device=self.device,
                **self._codec_opts())
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
        self.tp = bool(tp)
        self._init_lm()

    def _transform(self, frame):
        net, tok = self._require()
        kw = self._forward_kw(net.device)
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
                with full_f32():
                    toks = net.generate(
                        np.stack([prompts[i] for i in chunk]), self.maxNew,
                        temperature=self.temperature, generator=gen,
                        prompt_buckets=ladder, **kw).cpu().numpy()
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
