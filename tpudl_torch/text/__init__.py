"""Text for the port: tokenizers (``tokenizer``), the token codec and
packing (``codec``) and the LM training feed (``data``)."""

from tpudl_torch.text.codec import (TokenCodec, lengths, pack_dense,
                                    pack_ragged, pad_mask, tokenize_pack)
from tpudl_torch.text.data import lm_dataset
from tpudl_torch.text.tokenizer import (BOS_ID, EOS_ID, PAD_ID, UNK_ID,
                                        ByteTokenizer, Tokenizer,
                                        WordTokenizer, load_vocab,
                                        tokenizer_from_spec)

__all__ = ["TokenCodec", "pad_mask", "lengths", "pack_ragged", "pack_dense",
           "tokenize_pack", "lm_dataset", "Tokenizer", "ByteTokenizer",
           "WordTokenizer", "tokenizer_from_spec", "load_vocab", "PAD_ID",
           "BOS_ID", "EOS_ID", "UNK_ID"]
