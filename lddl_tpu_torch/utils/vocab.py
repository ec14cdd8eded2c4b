"""A ``vocab.txt`` reader with the tokenizer interface the collate uses.

Counterpart of the tokenizer that ``lddl_tpu/preprocess/tokenizer.py``
provisions (``transformers.BertTokenizerFast`` over a vocab file). The
collate never tokenizes text: schema-v2 shards store token ids. It only
looks up the special tokens, the vocabulary size (the range of random
replacement tokens in dynamic masking) and, for string tokens, ids. So
the port needs no ``transformers``: a token's id is its line index in the
vocab file, as ``BertTokenizerFast`` assigns ids for a vocab file. The
preprocess tokenizes with the native engine from the same table
(``preprocess.tokenizer.get_tokenizer``), which also carries
``do_lower_case``.
"""

import os


class Vocab:
    """Token <-> id table read from a one-token-per-line vocab file."""

    def __init__(self, vocab_file, unk_token="[UNK]", do_lower_case=True):
        if not os.path.isfile(vocab_file):
            raise FileNotFoundError(
                "vocab file not found: {}".format(vocab_file))
        vocab = {}
        with open(vocab_file, "r", encoding="utf-8") as f:
            for index, line in enumerate(f):
                vocab[line.rstrip("\n")] = index
        self._vocab = vocab
        self._tokens = None   # id -> token, made at first use
        self.unk_token = unk_token
        self.do_lower_case = bool(do_lower_case)

    def __len__(self):
        return len(self._vocab)

    def get_vocab(self):
        return dict(self._vocab)

    def convert_tokens_to_ids(self, token):
        """Id of one token; unknown tokens map to the ``[UNK]`` id."""
        if token in self._vocab:
            return self._vocab[token]
        return self._vocab[self.unk_token]

    def convert_ids_to_tokens(self, ids):
        """The tokens of a list of ids (an id is its token's line)."""
        if self._tokens is None:
            self._tokens = [None] * (max(self._vocab.values(), default=-1)
                                     + 1)
            for token, index in self._vocab.items():
                self._tokens[index] = token
        return [self._tokens[i] for i in ids]
