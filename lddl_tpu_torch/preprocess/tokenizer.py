"""Tokenizer provisioning.

Counterpart of ``lddl_tpu/preprocess/tokenizer.py``. The reference
provisions a ``transformers.BertTokenizerFast`` over a vocab file or a
pretrained name; the port reads the vocab file itself
(``utils.vocab.Vocab``) and tokenizes with its native engine, whose
semantics are exactly a vocab-file ``BertTokenizerFast``'s (WordPiece with
the default BertNormalizer and BertPreTokenizer). A pretrained name is
taken as a local directory holding ``vocab.txt`` (the layout
``from_pretrained`` reads from a directory); the port downloads nothing
and needs no ``transformers``. ``build_wordpiece_vocab`` is a copy of the
reference's deterministic trainer.
"""

import collections
import os
import unicodedata

from ..utils.vocab import Vocab


def get_tokenizer(vocab_file=None, do_lower_case=True,
                  pretrained_model_name=None):
    """The vocab table (token id = line index) of ``vocab_file``, or of
    ``<pretrained_model_name>/vocab.txt`` for a local directory, with its
    ``do_lower_case``: what ``preprocess.bert.TokenizerInfo`` builds
    from and what the loaders' collates read."""
    if vocab_file is None and pretrained_model_name is not None:
        if not os.path.isdir(pretrained_model_name):
            raise ValueError(
                "tokenizer name {!r} is not a local directory: the port "
                "reads <name>/vocab.txt and downloads nothing".format(
                    pretrained_model_name))
        vocab_file = os.path.join(pretrained_model_name, "vocab.txt")
    if vocab_file is None:
        raise ValueError("need vocab_file or pretrained_model_name")
    if not os.path.isfile(vocab_file):
        raise FileNotFoundError("vocab file not found: {}".format(vocab_file))
    return Vocab(vocab_file, do_lower_case=do_lower_case)


SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def _is_bert_punctuation(c):
    """BERT's punctuation predicate (category P plus the ASCII symbol
    ranges), matching the encode-time pre-tokenizer — both the HF
    BertTokenizerFast and the native engine's tables
    (native/gen_tables.py) isolate exactly this set."""
    cp = ord(c)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(c).startswith("P")


def _count_word_types(texts, do_lower_case):
    """Word-type frequencies after BERT-style pre-tokenization (whitespace
    split + punctuation isolation + lowercase/NFD-strip-accents normalize) —
    the same word boundary the WordPiece munch sees at encode time."""
    counter = collections.Counter()
    for t in texts:
        if do_lower_case:
            t = t.lower()
        t = unicodedata.normalize("NFD", t)
        t = "".join(c for c in t if unicodedata.category(c) != "Mn")
        for chunk in t.split():
            word = []
            for c in chunk:
                if _is_bert_punctuation(c):
                    if word:
                        counter["".join(word)] += 1
                        word = []
                    counter[c] += 1
                else:
                    word.append(c)
            if word:
                counter["".join(word)] += 1
    return counter


def build_wordpiece_vocab(texts, out_path, vocab_size=30000,
                          do_lower_case=True, min_frequency=1):
    """Train a WordPiece vocab from an iterable of texts; write one token
    per line (BERT vocab format). Returns the path.

    Fully deterministic by construction — unlike the HF ``tokenizers``
    WordPiece trainer, whose Rust hash-map iteration makes both the id
    order AND the selected token set vary run to run (observed; it broke
    byte-reproducibility of every downstream shard). Here: BPE-style
    greedy pair merging over word types, scored by pair frequency with
    lexicographic tie-break, alphabet and merges emitted in a canonical
    order. WordPiece encoding (greedy longest-match) only consumes the
    token *set*, so canonical ordering is free.
    """
    import heapq

    counter = _count_word_types(texts, do_lower_case)

    # Word types as symbol sequences: first char bare, continuations "##c".
    words = []  # [freq, [symbols...]]
    for word, freq in sorted(counter.items()):
        words.append([freq, [word[0]] + ["##" + c for c in word[1:]]])

    alphabet = sorted({s for _, syms in words for s in syms})
    vocab = list(SPECIAL_TOKENS) + alphabet
    seen = set(vocab)

    # Pair occurrence counts + posting lists (word indices; refreshed
    # lazily — a stale posting just re-derives the word's current pairs).
    pair_counts = collections.Counter()
    postings = collections.defaultdict(set)
    for wi, (freq, syms) in enumerate(words):
        for a, b in zip(syms, syms[1:]):
            pair_counts[(a, b)] += freq
            postings[(a, b)].add(wi)

    def merged_name(a, b):
        return a + b[2:] if b.startswith("##") else a + b

    heap = [(-c, p) for p, c in pair_counts.items()]
    heapq.heapify(heap)
    while len(vocab) < vocab_size and heap:
        neg, pair = heapq.heappop(heap)
        count = pair_counts.get(pair, 0)
        if count != -neg:  # stale heap entry
            if count >= min_frequency:
                heapq.heappush(heap, (-count, pair))
            continue
        if count < min_frequency:
            break
        new_sym = merged_name(*pair)
        if new_sym in seen:  # already produced via another merge path
            del pair_counts[pair]
            continue
        vocab.append(new_sym)
        seen.add(new_sym)
        a, b = pair
        touched = set()
        for wi in postings.pop(pair, ()):
            freq, syms = words[wi]
            out = []
            i = 0
            while i < len(syms):
                if i + 1 < len(syms) and syms[i] == a and syms[i + 1] == b:
                    out.append(new_sym)
                    i += 2
                else:
                    out.append(syms[i])
                    i += 1
            if len(out) == len(syms):  # stale posting: pair no longer here
                continue
            # Apply the pair-count delta by recount (clearer than in-place
            # neighborhood surgery, same asymptotics: O(len) per word).
            for p in zip(syms, syms[1:]):
                pair_counts[p] -= freq
                touched.add(p)
            for p in zip(out, out[1:]):
                pair_counts[p] += freq
                touched.add(p)
                postings[p].add(wi)
            words[wi][1] = out
        pair_counts.pop(pair, None)
        touched.discard(pair)
        for p in touched:
            c = pair_counts.get(p, 0)
            if c >= min_frequency:
                heapq.heappush(heap, (-c, p))
            elif c <= 0:
                pair_counts.pop(p, None)
                postings.pop(p, None)

    from ..utils.io import atomic_write
    atomic_write(out_path, "".join(t + "\n" for t in vocab))
    return out_path
