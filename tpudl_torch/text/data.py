"""LM dataset assembly: one call from a string column to the cached,
wire-coded, epoch-replayable training feed.

Port of ``tpudl/text/data.py``. :func:`lm_dataset` wires
:func:`~tpudl_torch.text.codec.tokenize_pack` (tokenize + dense pack) and
:class:`~tpudl_torch.text.codec.TokenCodec` (u16 ids on the wire, int32
restored on the card) into a :class:`~tpudl_torch.data.dataset.Dataset`
whose cache keys carry the tokenizer's fingerprint: epoch 2 of a
fine-tune tokenizes nothing, and with ``device_cache=True`` ships
nothing.
"""

from __future__ import annotations

from tpudl_torch.text.codec import TokenCodec, tokenize_pack
from tpudl_torch.text.tokenizer import Tokenizer

__all__ = ["lm_dataset"]


def lm_dataset(frame, col: str, tokenizer: Tokenizer, *, seq_len: int,
               batch_size: int = 64, eos: bool = True,
               cache_dir: str | None = None, retain: bool = False,
               device_cache: bool = False, mesh=None, device="cuda"):
    """A :class:`~tpudl_torch.data.dataset.Dataset` of densely packed
    ``[rows, seq_len]`` LM-training batches over ``frame[col]``.

    Each batch tokenizes ``batch_size`` strings (``eos=True`` puts the
    document separator between them) and packs the id stream into
    ``seq_len`` rows — pad waste only in each batch's final row — then
    wire-encodes it with :class:`TokenCodec` (uint16 when the vocab
    fits). Train a :class:`~tpudl_torch.zoo.transformer.TinyCausalLM` on
    it with ``Trainer(ds.wrap(model.loss_fn()), ...)`` and a ``data_fn``
    over ``ds.get_batch``: the wrapped loss restores the int32 ids in
    front of the model. ``device_cache=True`` keeps the batches resident
    on ``device``."""
    from tpudl_torch.data.dataset import Dataset

    pack = tokenize_pack(tokenizer, seq_len=int(seq_len), dense=True,
                         eos=eos)
    codec = TokenCodec(vocab_size=tokenizer.vocab_size)
    return Dataset(frame, [col], batch_size=batch_size, wire_codec=codec,
                   cache_dir=cache_dir, pack=pack, retain=retain,
                   device_cache=device_cache, mesh=mesh, device=device)
