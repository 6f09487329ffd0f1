"""Token wire codec + sequence packing: ragged strings → rung-shaped
int32 batches.

Copied from ``tpudl/text/codec.py`` (``TokenCodec``, ``pad_mask``,
``pack_ragged``, ``pack_dense``, ``tokenize_pack``); the host halves are
unchanged, the device halves (``TokenCodec.prologue``, ``pad_mask``) are
torch. The wire type follows the vocab alone, and ``tokenize_pack`` keeps
no ``cache_token`` (the port has no shard or device cache yet).

- :class:`TokenCodec` ships token ids as uint16 when the vocab fits
  (half the wire bytes of int32) and restores them on the device with one
  cast to int32 — exact, ids are integers.
- :func:`tokenize_pack` builds the string-column pack fn for
  ``Frame.map_batches(pack=)``: rows 1:1 with the input strings,
  right-padded with id 0 to a bucket-ladder rung (:func:`pack_ragged`),
  or, with ``dense=True``, the training layout (:func:`pack_dense`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpudl_torch.compile.buckets import resolve_ladder
from tpudl_torch.data.codec import CodecError, WireCodec
from tpudl_torch.obs import metrics as _m
from tpudl_torch.text.tokenizer import PAD_ID, Tokenizer

__all__ = ["TokenCodec", "pad_mask", "pack_ragged", "pack_dense",
           "tokenize_pack"]


class TokenCodec(WireCodec):
    """Integer token ids on the wire — uint16 when the vocab fits,
    restored on the device by one cast to int32. ``encode``
    bounds-checks every batch against ``vocab_size``, so an id from the
    wrong tokenizer fails host-side instead of gathering a garbage
    embedding row."""

    name = "tokens"

    def __init__(self, *, pad_id: int = PAD_ID, vocab_size=None):
        self.pad_id = int(pad_id)
        self.vocab_size = None if vocab_size is None else int(vocab_size)
        self.wire = ("u16" if self.vocab_size is not None
                     and self.vocab_size <= (1 << 16) else "i32")

    def key(self) -> tuple:
        return (self.name, self.pad_id, self.vocab_size, self.wire)

    def encode(self, arr: np.ndarray) -> np.ndarray:
        arr = np.asarray(arr)
        if not np.issubdtype(arr.dtype, np.integer):
            raise CodecError(
                f"tokens codec encodes integer id batches, got {arr.dtype}")
        if arr.size:
            lo, hi = int(arr.min()), int(arr.max())
            if lo < 0:
                raise CodecError(f"token ids must be >= 0 (min {lo})")
            if self.vocab_size is not None and hi >= self.vocab_size:
                raise CodecError(
                    f"token id {hi} out of range for vocab_size="
                    f"{self.vocab_size} — wrong tokenizer for this model?")
        return arr.astype(np.uint16 if self.wire == "u16" else np.int32)

    def prologue(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.int32)


def pad_mask(tokens: torch.Tensor, pad_id: int = PAD_ID) -> torch.Tensor:
    """float32 mask (1 = real, 0 = pad), computed on the tokens' device
    from the shipped ids, so no mask crosses the wire."""
    return (tokens != pad_id).to(torch.float32)


def pack_ragged(seqs, *, buckets="pow2", pad_id: int = PAD_ID,
                max_len=None) -> np.ndarray:
    """Ragged id vectors → one right-padded int32 batch whose seq dim
    snaps to a bucket-ladder rung (capped at ``max_len``)."""
    ladder = resolve_ladder(buckets if buckets is not None else "pow2")
    seqs = [np.asarray(s, dtype=np.int32).reshape(-1) for s in seqs]
    longest = max((len(s) for s in seqs), default=0)
    if max_len is not None:
        longest = min(longest, int(max_len))
    width = max(1, ladder.pick(longest) if ladder is not None else longest)
    out = np.full((len(seqs), width), int(pad_id), dtype=np.int32)
    for i, s in enumerate(seqs):
        s = s[:width]
        out[i, : len(s)] = s
    return out


def pack_dense(seqs, seq_len: int, *, pad_id: int = PAD_ID) -> np.ndarray:
    """Dense LM-training packing: concatenate the id streams and chunk
    into ``seq_len`` rows — pad waste only in the final partial row (the
    separator policy — eos between documents — is the tokenizer call's
    ``eos=True``, upstream of here). Always emits at least one row so a
    batch of empty strings still has the declared shape."""
    seq_len = int(seq_len)
    if seq_len < 1:
        raise ValueError(f"seq_len must be >= 1, got {seq_len}")
    flat = (np.concatenate([np.asarray(s, dtype=np.int32).reshape(-1)
                            for s in seqs])
            if len(seqs) else np.zeros(0, dtype=np.int32))
    n_rows = max(1, -(-int(flat.size) // seq_len))
    out = np.full(n_rows * seq_len, int(pad_id), dtype=np.int32)
    out[: flat.size] = flat
    return out.reshape(n_rows, seq_len)


def tokenize_pack(tokenizer: Tokenizer, *, seq_len=None, buckets="pow2",
                  pad_id: int = PAD_ID, bos: bool = False,
                  eos: bool = False, dense: bool = False):
    """Build the string-column pack fn for ``Frame.map_batches(pack=)``:
    tokenize, then :func:`pack_ragged` (rows 1:1 with the strings, capped
    at ``seq_len`` when given) or, with ``dense=True`` (which requires
    ``seq_len``), :func:`pack_dense`. Publishes the ``text.tokenize.*``
    and ``text.pack.*`` metrics."""
    if dense and seq_len is None:
        raise ValueError("dense packing requires seq_len")
    ladder = resolve_ladder(buckets if buckets is not None else "pow2")

    def pack(col) -> np.ndarray:
        t0 = time.perf_counter()
        seqs = tokenizer.encode_batch(list(np.asarray(col, dtype=object)),
                                      bos=bos, eos=eos)
        n_tok = int(sum(len(s) for s in seqs))
        _m.counter("text.tokenize.calls").inc()
        _m.counter("text.tokenize.tokens").inc(n_tok)
        _m.histogram("text.tokenize.seconds").observe(
            time.perf_counter() - t0)
        if dense:
            out = pack_dense(seqs, int(seq_len), pad_id=pad_id)
        else:
            out = pack_ragged(seqs, buckets=ladder, pad_id=pad_id,
                              max_len=seq_len)
        _m.counter("text.pack.rows").inc(int(out.shape[0]))
        pad_tokens = int(out.size) - min(n_tok, int(out.size))
        _m.counter("text.pack.pad_tokens").inc(pad_tokens)
        if out.size:
            _m.gauge("text.pack.fill_pct").set(
                100.0 * (1.0 - pad_tokens / out.size))
        return out

    return pack
