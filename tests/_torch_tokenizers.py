"""Tokenizer directories for the port's tests of its HF engine: a
``save_pretrained`` ``BertTokenizerFast`` layout built locally from a
vocab file (nothing is downloaded)."""

import os

# Accented pieces added to a corpus vocab, so a normalizer that keeps
# accents finds them (build_wordpiece_vocab strips accents).
ACCENTED = ("café", "naïve", "##é", "##ï")


def save_tokenizer_dir(path, vocab, accented=False, **kw):
    """``BertTokenizerFast(vocab, **kw).save_pretrained(path)`` over
    ``vocab`` (plus ``ACCENTED`` when asked); returns ``path``."""
    from transformers import BertTokenizerFast
    os.makedirs(path, exist_ok=True)
    if accented:
        with open(vocab, encoding="utf-8") as f:
            tokens = f.read().splitlines()
        vocab = os.path.join(path, "base_vocab.txt")
        with open(vocab, "w", encoding="utf-8") as f:
            f.write("".join(t + "\n" for t in tokens + list(ACCENTED)))
    BertTokenizerFast(vocab, **kw).save_pretrained(path)
    if accented:
        os.unlink(vocab)
    return path


def keep_accents_dir(path, vocab):
    """``BertTokenizerFast(vocab, do_lower_case=True,
    strip_accents=False)`` saved with ``save_pretrained``: a normalizer
    the native engine does not implement."""
    return save_tokenizer_dir(path, vocab, accented=True,
                              do_lower_case=True, strip_accents=False)
