"""Text for the port: tokenizers (``tokenizer``) and the token codec and
packing (``codec``)."""

from tpudl_torch.text.codec import (TokenCodec, pack_dense, pack_ragged,
                                    pad_mask, tokenize_pack)
from tpudl_torch.text.tokenizer import (BOS_ID, EOS_ID, PAD_ID, UNK_ID,
                                        ByteTokenizer, Tokenizer,
                                        WordTokenizer, load_vocab,
                                        tokenizer_from_spec)

__all__ = ["TokenCodec", "pad_mask", "pack_ragged", "pack_dense",
           "tokenize_pack", "Tokenizer", "ByteTokenizer", "WordTokenizer",
           "tokenizer_from_spec", "load_vocab", "PAD_ID", "BOS_ID",
           "EOS_ID", "UNK_ID"]
