"""TinyCausalLM — the small pre-norm causal decoder LM, as an ``nn.Module``.

Port of ``tpudl/zoo/transformer.py`` (``TinyCausalLM``: ``init``,
``hidden``/``apply``, ``_decoder_block``, ``init_cache``/``decode_step``/
``generate``). The math and the public layouts are tpudl's: weights are
kept in its ``x @ W`` orientation under its names (``embed.table``,
``blocks.<i>.wq``, …), attention works on ``[B, S, H, D]``, and
:func:`load_jax_params` fills the module from tpudl's numpy param pytree,
so both packages run the same model from the same ``init(seed)``.

The full-sequence forward (:meth:`TinyCausalLM.hidden`) runs attention
through :func:`tpudl_torch.cuda_ops.flash_attention` (the hand-written
CUDA kernels on the card, forward and, under autograd, backward), and
:meth:`TinyCausalLM.loss_fn` is tpudl's next-token training loss. The
KV-cache decode step keeps tpudl's dense masked attention over the cache.
The cache is updated in place (``decode_step`` returns the same list it
was given) — JAX had to return a new one. :func:`to_jax_params` carries
the module's weights back to tpudl's numpy param pytree.

Not ported yet, and refused with ``NotImplementedError``: mixture of
experts, tensor parallelism, ring attention over a mesh, the pipelined
forward (ROADMAP Queue 1, "LM parallelism") and AOT precompilation
(ROADMAP Queue 1, "Compile").
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpudl_torch import cuda_ops
from tpudl_torch.compile.buckets import resolve_ladder
from tpudl_torch.device import resolve_device

__all__ = ["TinyCausalLM", "load_jax_params", "to_jax_params"]


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to tpudl_torch yet (ROADMAP Queue 1, "
        f"{item!r})")


def _layer_norm(x, p, prefix=""):
    return F.layer_norm(x, (x.shape[-1],), p[prefix + "gamma"],
                        p[prefix + "beta"], eps=1e-5)


class TinyCausalLM(nn.Module):
    """A small pre-norm decoder LM: embed → [attn + mlp]×L → tied logits.

    Parameters are allocated as zeros on ``device`` (default ``"cuda"``);
    fill them with :func:`load_jax_params` (or build in one call with
    :meth:`from_jax_params`). The module trains like any other: gradients
    of :meth:`loss_fn` reach every parameter, through the flash backward
    kernels on the card."""

    def __init__(self, vocab: int = 256, dim: int = 64, heads: int = 4,
                 layers: int = 2, max_len: int = 4096, experts: int = 0,
                 *, device="cuda"):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} not divisible by heads {heads}")
        if experts:
            _not_ported("experts > 0 (top-1 mixture-of-experts blocks)",
                        "LM parallelism")
        self.vocab = vocab
        self.dim = dim
        self.heads = heads
        self.layers = layers
        self.max_len = max_len
        dev = resolve_device(device)

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, device=dev))

        d = dim
        self.embed = nn.ParameterDict({"table": zeros(vocab, d)})
        self.final_norm = nn.ParameterDict({"gamma": zeros(d),
                                            "beta": zeros(d)})
        self.blocks = nn.ModuleList(nn.ParameterDict({
            "norm1_gamma": zeros(d), "norm1_beta": zeros(d),
            "wq": zeros(d, d), "wk": zeros(d, d), "wv": zeros(d, d),
            "wo": zeros(d, d),
            "norm2_gamma": zeros(d), "norm2_beta": zeros(d),
            "w_up": zeros(d, 4 * d), "b_up": zeros(4 * d),
            "w_down": zeros(4 * d, d), "b_down": zeros(d),
        }) for _ in range(layers))

    @classmethod
    def from_jax_params(cls, params, *, vocab: int, dim: int, heads: int,
                        layers: int, max_len: int = 4096,
                        device="cuda") -> "TinyCausalLM":
        """Build the module on ``device`` and load tpudl's param pytree."""
        model = cls(vocab, dim, heads, layers, max_len, device=device)
        return load_jax_params(model, params)

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    # -- params -----------------------------------------------------------
    def init(self, seed: int = 0) -> dict:
        """tpudl's seeded numpy param pytree, bit-equal to
        ``tpudl.zoo.transformer.TinyCausalLM.init(seed)`` (same draws, same
        order). Load it with :func:`load_jax_params`."""
        rng = np.random.default_rng(seed)
        d, v = self.dim, self.vocab

        def w(*shape, scale=None):
            scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
            return (rng.normal(size=shape) * scale).astype(np.float32)

        params: dict = {
            "embed": {"table": w(v, d, scale=0.02)},
            "final_norm": {"gamma": np.ones(d, np.float32),
                           "beta": np.zeros(d, np.float32)},
        }
        for i in range(self.layers):
            params[f"block_{i}"] = {
                "norm1_gamma": np.ones(d, np.float32),
                "norm1_beta": np.zeros(d, np.float32),
                "wq": w(d, d), "wk": w(d, d), "wv": w(d, d), "wo": w(d, d),
                "norm2_gamma": np.ones(d, np.float32),
                "norm2_beta": np.zeros(d, np.float32),
                "w_up": w(d, 4 * d), "b_up": np.zeros(4 * d, np.float32),
                "w_down": w(4 * d, d),
                "b_down": np.zeros(d, np.float32),
            }
        return params

    def shard_params(self, *args, **kwargs):
        _not_ported("tensor-parallel param sharding", "LM parallelism")

    # -- forward ----------------------------------------------------------
    def _single_device(self, mesh, tp):
        if mesh is not None:
            _not_ported("attention over a mesh (ring attention)",
                        "LM parallelism")
        if tp:
            _not_ported("tensor parallelism (tp=True)", "LM parallelism")

    def apply(self, tokens, *, mesh=None, tp: bool = False,
              remat: bool = False):
        """tokens ``[B, S]`` int → logits ``[B, S, vocab]`` (tied head).
        tpudl's name; it shadows ``nn.Module.apply(fn)``."""
        x = self.hidden(tokens, mesh=mesh, tp=tp, remat=remat)
        return x @ self.embed["table"].T

    forward = apply

    def hidden(self, tokens, *, mesh=None, tp: bool = False,
               remat: bool = False):
        """tokens ``[B, S]`` int → final-norm hidden states ``[B, S, D]``:
        :meth:`apply` minus the head. Causal attention runs the flash
        kernel (12 launches for a 12-layer model). ``remat=True``
        checkpoints each block (``torch.utils.checkpoint``, the
        counterpart of tpudl's ``jax.checkpoint``): its activations are
        recomputed in the backward, so the forward kernel runs twice per
        block per training step."""
        self._single_device(mesh, tp)
        b, s = tokens.shape
        if s > self.max_len:
            raise ValueError(
                f"sequence length {s} exceeds max_len {self.max_len}")
        x = F.embedding(tokens, self.embed["table"])

        def attn(q, k, v):
            return cuda_ops.flash_attention(q, k, v, causal=True)

        for p in self.blocks:
            if remat:
                x = checkpoint(self._decoder_block, x, p, attn,
                               use_reentrant=False)
            else:
                x = self._decoder_block(x, p, attn)
        return _layer_norm(x, self.final_norm)

    def apply_pipelined(self, *args, **kwargs):
        _not_ported("the pipelined forward (apply_pipelined)",
                    "LM parallelism")

    def _decoder_block(self, x, p, attn):
        """One pre-norm decoder block, shared by the full forward (flash
        ``attn``) and the KV-cache step (cached ``attn``). The MLP's gelu
        is the tanh approximation, jax.nn.gelu's default."""
        b, s = x.shape[0], x.shape[1]
        h = _layer_norm(x, p, "norm1_")
        shape = (b, s, self.heads, self.dim // self.heads)
        q, k, v = (h @ p[w] for w in ("wq", "wk", "wv"))
        att = attn(q.reshape(shape), k.reshape(shape), v.reshape(shape))
        x = x + att.reshape(b, s, self.dim) @ p["wo"]
        h = _layer_norm(x, p, "norm2_")
        h = F.gelu(h @ p["w_up"] + p["b_up"], approximate="tanh")
        return x + h @ p["w_down"] + p["b_down"]

    # -- autoregressive decode (KV cache) ----------------------------------
    def init_cache(self, batch: int, max_len: int | None = None,
                   dtype=None) -> list:
        """Per-layer K/V buffers ``[B, max_len, heads, head_dim]`` of zeros
        (dtype follows the params unless given)."""
        length = max_len or self.max_len
        dtype = dtype or self.embed["table"].dtype
        shape = (batch, length, self.heads, self.dim // self.heads)
        return [{"k": torch.zeros(shape, dtype=dtype, device=self.device),
                 "v": torch.zeros(shape, dtype=dtype, device=self.device)}
                for _ in range(self.layers)]

    def decode_step(self, tok, cache, pos: int):
        """One incremental step: token ids ``tok`` ``[B]`` at position
        ``pos`` → (logits ``[B, vocab]``, cache). Each block's K/V for the
        token are written into ``cache`` at ``pos`` (in place) and
        attention reads the cache masked to positions ``0..pos``."""
        cache_len = cache[0]["k"].shape[1]
        pos = int(pos)
        if not 0 <= pos < cache_len:
            raise ValueError(
                f"pos {pos} out of range for cache length {cache_len}")
        x = F.embedding(tok, self.embed["table"])[:, None]   # [B, 1, D]
        for p, layer_cache in zip(self.blocks, cache):
            x = self._decoder_block(x, p, _cached_attn(layer_cache, pos))
        x = _layer_norm(x[:, 0], self.final_norm)
        return x @ self.embed["table"].T, cache

    def _gen_bucket(self, plen: int, max_new: int, prompt_buckets) -> int:
        """Padded prompt length: the smallest ladder rung ≥ plen that
        still fits ``max_len`` with ``max_new`` to go (``None`` = exact)."""
        ladder = resolve_ladder(prompt_buckets)
        if ladder is None:
            return plen
        return max(plen, min(ladder.pick(plen), self.max_len - max_new))

    @torch.inference_mode()
    def generate(self, prompt, max_new: int, *, temperature: float = 0.0,
                 generator: torch.Generator | None = None,
                 prompt_buckets=None, mesh=None, tp: bool = False):
        """Autoregressive continuation: ``prompt`` ``[B, P]`` ints →
        ``[B, max_new]`` int32 on the model's device. Prefill runs
        :meth:`decode_step` over the prompt, generation feeds each pick
        back in. ``temperature=0`` is greedy argmax; otherwise softmax
        sampling drawn from ``generator`` (a ``torch.Generator`` on the
        model's device).

        ``prompt_buckets`` sizes the KV cache as tpudl does (the prompt's
        ladder rung + ``max_new``). The prefill stops at the real prompt
        length: tpudl's extra steps over pad tokens only wrote cache slots
        that generation overwrites before any step attends them, so the
        tokens are the same."""
        self._single_device(mesh, tp)
        prompt = torch.as_tensor(prompt, dtype=torch.int32,
                                 device=self.device)
        b, plen = prompt.shape
        if plen + max_new > self.max_len:
            raise ValueError(f"prompt {plen} + max_new {max_new} exceeds "
                             f"max_len {self.max_len}")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if plen < 1:
            raise ValueError(f"prompt must hold >= 1 token, got shape "
                             f"{tuple(prompt.shape)}")
        if temperature > 0 and generator is None:
            raise ValueError("sampling (temperature > 0) needs generator=")
        padded = self._gen_bucket(plen, max_new, prompt_buckets)
        cache = self.init_cache(b, padded + max_new)
        for pos in range(plen):
            logits, cache = self.decode_step(prompt[:, pos], cache, pos)
        out = [_pick(logits, temperature, generator)]
        for i in range(1, max_new):
            logits, cache = self.decode_step(out[-1], cache, plen + i - 1)
            out.append(_pick(logits, temperature, generator))
        return torch.stack(out, dim=1)

    def precompile_generate(self, *args, **kwargs):
        _not_ported("AOT precompilation of generate", "Compile")

    # -- training loss -----------------------------------------------------
    def loss_fn(self, *, mesh=None, use_pallas: bool = False,
                remat: bool = False, tp: bool = False):
        """``loss(model, tokens)``: next-token cross-entropy of ``model``
        (a :class:`TinyCausalLM` of this architecture) on ``tokens``
        ``[B, S]``, the mean over the batch, with logits cast to f32 —
        tpudl's ``loss_fn``, with the module in the place of the param
        pytree. ``remat=True`` checkpoints each block (see :meth:`hidden`).

        ``use_pallas`` is accepted and changes nothing: tpudl picks
        between dense attention and its Pallas kernel, which it proves
        equal; here both run the flash op (the CUDA kernels on the card).
        ``mesh=`` and ``tp=True`` are refused."""
        self._single_device(mesh, tp)

        def loss(model, tokens):
            logits = model.apply(tokens[:, :-1], remat=remat)
            return F.cross_entropy(logits.float().flatten(0, 1),
                                   tokens[:, 1:].flatten().long())

        return loss


def _cached_attn(layer_cache: dict, pos: int):
    """Attention for one decode step: write this token's K/V at ``pos``,
    then dense softmax over the cache masked to keys ``<= pos``."""
    def attn(q, k_t, v_t):                   # all [B, 1, H, Dh]
        kc, vc = layer_cache["k"], layer_cache["v"]
        kc[:, pos] = k_t[:, 0].to(kc.dtype)
        vc[:, pos] = v_t[:, 0].to(vc.dtype)
        scores = (torch.einsum("bqhd,bshd->bhqs", q, kc)
                  * (1.0 / math.sqrt(q.shape[-1])))
        live = torch.arange(kc.shape[1], device=q.device) <= pos
        scores = scores.masked_fill(~live, float("-inf"))
        w = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqs,bshd->bqhd", w, vc)

    return attn


def _pick(logits, temperature: float, generator):
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)
    return logits.argmax(dim=-1).to(torch.int32)


def _param_groups(model: TinyCausalLM) -> dict:
    """tpudl's param group name → the module's ``ParameterDict``."""
    groups = {"embed": model.embed, "final_norm": model.final_norm}
    groups.update({f"block_{i}": p for i, p in enumerate(model.blocks)})
    return groups


def to_jax_params(model: TinyCausalLM) -> dict:
    """The module's weights as tpudl's param pytree of numpy arrays (host
    copies): the inverse of :func:`load_jax_params`."""
    return {name: {key: t.detach().cpu().numpy().copy()
                   for key, t in group.items()}
            for name, group in _param_groups(model).items()}


def load_jax_params(model: TinyCausalLM, params) -> TinyCausalLM:
    """Copy tpudl's param pytree (``{"embed": {"table"}, "final_norm":
    {...}, "block_<i>": {...}}`` of numpy or jax arrays) into ``model``.
    Names and shapes must match exactly; returns ``model``."""
    groups = _param_groups(model)
    if set(params) != set(groups):
        raise KeyError(f"param groups {sorted(params)} do not match the "
                       f"model's {sorted(groups)}")
    with torch.no_grad():
        for name, group in groups.items():
            src = params[name]
            if set(src) != set(group.keys()):
                raise KeyError(f"{name}: params {sorted(src)} do not match "
                               f"the model's {sorted(group.keys())}")
            for key, dst in group.items():
                arr = np.asarray(src[key])
                if arr.shape != tuple(dst.shape):
                    raise ValueError(f"{name}.{key}: shape {arr.shape} != "
                                     f"model {tuple(dst.shape)}")
                dst.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    return model
