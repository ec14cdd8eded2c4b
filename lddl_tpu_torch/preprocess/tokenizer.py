"""Tokenizer provisioning.

Counterpart of ``lddl_tpu/preprocess/tokenizer.py``. The reference
provisions a ``transformers.BertTokenizerFast`` over a vocab file or a
pretrained name. The port gives:

- for a vocab file, or a directory that holds only ``vocab.txt``, the
  vocab table itself (``utils.vocab.Vocab``): the native engine's
  semantics are exactly a vocab-file ``BertTokenizerFast``'s (WordPiece
  with the default BertNormalizer and BertPreTokenizer), so nothing else
  is imported on that path;
- for a directory that holds a ``tokenizer.json`` (a ``save_pretrained``
  layout), ``FastBertTokenizer``: the ``tokenizers`` backend that
  ``BertTokenizerFast.from_pretrained(dir, do_lower_case=...)`` builds,
  with the same normalizer override. ``preprocess.bert`` tokenizes with
  the native engine only when that backend's semantics are the native
  engine's (``native_semantics_match``), and with the backend otherwise.

The port downloads nothing and needs no ``transformers``; ``tokenizers``
is imported only where a fast tokenizer is built. ``build_wordpiece_vocab``
is a copy of the reference's deterministic trainer.
"""

import collections
import json
import os
import unicodedata

from ..utils.vocab import Vocab

# BertTokenizerFast's special-token attributes, in transformers'
# SPECIAL_TOKENS_ATTRIBUTES order, with their defaults.
_SPECIAL_DEFAULTS = (("unk_token", "[UNK]"), ("sep_token", "[SEP]"),
                     ("pad_token", "[PAD]"), ("cls_token", "[CLS]"),
                     ("mask_token", "[MASK]"))


def get_tokenizer(vocab_file=None, do_lower_case=True,
                  pretrained_model_name=None):
    """What ``preprocess.bert.TokenizerInfo`` builds from and what the
    loaders' collates read: the vocab table (token id = line index) of
    ``vocab_file``, or for a local directory ``pretrained_model_name``
    its ``FastBertTokenizer`` when it holds a ``tokenizer.json`` or a
    ``tokenizer_config.json`` that changes the normalizer, else the table
    of its ``vocab.txt``; with ``do_lower_case`` either way."""
    if vocab_file is None and pretrained_model_name is not None:
        name = pretrained_model_name
        if not os.path.isdir(name):
            raise ValueError(
                "tokenizer name {!r} is not a local directory: the port "
                "reads a saved tokenizer directory and downloads "
                "nothing".format(name))
        config = _read_config(name)
        if (os.path.isfile(os.path.join(name, "tokenizer.json"))
                or config.get("strip_accents") is not None
                or not config.get("tokenize_chinese_chars", True)):
            return FastBertTokenizer.from_directory(
                name, do_lower_case=do_lower_case)
        vocab_file = os.path.join(name, "vocab.txt")
    if vocab_file is None:
        raise ValueError("need vocab_file or pretrained_model_name")
    if not os.path.isfile(vocab_file):
        raise FileNotFoundError("vocab file not found: {}".format(vocab_file))
    return Vocab(vocab_file, do_lower_case=do_lower_case)


def _read_config(directory):
    path = os.path.join(directory, "tokenizer_config.json")
    if not os.path.isfile(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _content(token):
    """A special token's string: a plain string, or the serialized
    ``AddedToken`` dict of a ``tokenizer_config.json``."""
    return token["content"] if isinstance(token, dict) else str(token)


class FastBertTokenizer:
    """A ``tokenizers.Tokenizer`` backend with the surface of
    ``BertTokenizerFast`` that the pipeline reads: ``_tokenizer`` (the
    backend, probed by ``native_semantics_match``), ``get_vocab()``,
    ``len()``, ``do_lower_case``, the special tokens and their ids,
    ``convert_tokens_to_ids`` and ``encode_texts`` (what calling the
    reference's tokenizer on a list of texts gives). Picklable, as the
    preprocess pool needs."""

    def __init__(self, backend, do_lower_case=True, special_tokens=None):
        self._tokenizer = backend
        self.do_lower_case = bool(do_lower_case)
        special = dict(_SPECIAL_DEFAULTS)
        special.update(special_tokens or {})
        for attr, token in special.items():
            setattr(self, attr, token)

    @property
    def backend_tokenizer(self):
        return self._tokenizer

    @classmethod
    def from_vocab(cls, vocab, do_lower_case=True, strip_accents=None,
                   tokenize_chinese_chars=True, special_tokens=None):
        """The backend that ``BertTokenizerFast(vocab_file,
        do_lower_case=...)`` converts from the slow tokenizer
        (transformers' ``BertConverter``) over the token -> id table
        ``vocab``, with its special tokens added."""
        from tokenizers import Tokenizer, decoders, normalizers
        from tokenizers import pre_tokenizers, processors
        from tokenizers.models import WordPiece
        special = dict(_SPECIAL_DEFAULTS)
        special.update(special_tokens or {})
        backend = Tokenizer(WordPiece(dict(vocab),
                                      unk_token=special["unk_token"]))
        backend.normalizer = normalizers.BertNormalizer(
            clean_text=True, handle_chinese_chars=tokenize_chinese_chars,
            strip_accents=strip_accents, lowercase=do_lower_case)
        backend.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
        cls_tok, sep_tok = special["cls_token"], special["sep_token"]
        backend.post_processor = processors.TemplateProcessing(
            single="{}:0 $A:0 {}:0".format(cls_tok, sep_tok),
            pair="{0}:0 $A:0 {1}:0 $B:1 {1}:1".format(cls_tok, sep_tok),
            special_tokens=[(cls_tok, backend.token_to_id(cls_tok)),
                            (sep_tok, backend.token_to_id(sep_tok))])
        backend.decoder = decoders.WordPiece(prefix="##")
        _add_special_tokens(backend, special.values(), ())
        return cls(backend, do_lower_case, special)

    @classmethod
    def from_directory(cls, directory, do_lower_case=True):
        """What ``BertTokenizerFast.from_pretrained(directory,
        do_lower_case=...)`` builds from a local directory: the backend of
        its ``tokenizer.json`` (or converted from its ``vocab.txt``), the
        special tokens and added tokens of its ``tokenizer_config.json``
        added where the backend lacks them, and the normalizer rebuilt
        when its ``lowercase``, ``strip_accents`` or
        ``handle_chinese_chars`` differ from ``do_lower_case`` and the
        config's ``strip_accents`` and ``tokenize_chinese_chars``, as
        ``BertTokenizerFast.__init__`` rebuilds it."""
        from tokenizers import Tokenizer, normalizers
        config = _read_config(directory)
        strip_accents = config.get("strip_accents")
        chinese = config.get("tokenize_chinese_chars", True)
        special = {attr: _content(config[attr])
                   for attr, _ in _SPECIAL_DEFAULTS
                   if config.get(attr) is not None}
        path = os.path.join(directory, "tokenizer.json")
        if not os.path.isfile(path):
            return cls.from_vocab(
                Vocab(os.path.join(directory, "vocab.txt")).get_vocab(),
                do_lower_case, strip_accents, chinese, special)
        backend = Tokenizer.from_file(path)
        added = [v for _, v in sorted(
            (int(k), v) for k, v in
            config.get("added_tokens_decoder", {}).items())]
        merged = dict(_SPECIAL_DEFAULTS)
        merged.update(special)
        _add_special_tokens(backend, merged.values(), added)
        backend.encode_special_tokens = bool(
            config.get("split_special_tokens", False))
        state = json.loads(backend.normalizer.__getstate__())
        if (state.get("lowercase", do_lower_case) != do_lower_case
                or state.get("strip_accents", strip_accents) != strip_accents
                or state.get("handle_chinese_chars", chinese) != chinese):
            norm_cls = getattr(normalizers, state.pop("type"))
            state["lowercase"] = do_lower_case
            state["strip_accents"] = strip_accents
            state["handle_chinese_chars"] = chinese
            backend.normalizer = norm_cls(**state)
        return cls(backend, do_lower_case, special)

    def get_vocab(self):
        return self._tokenizer.get_vocab(with_added_tokens=True)

    def __len__(self):
        return self._tokenizer.get_vocab_size(with_added_tokens=True)

    def convert_tokens_to_ids(self, token):
        """Id of one token; unknown tokens map to the ``unk_token`` id."""
        i = self._tokenizer.token_to_id(token)
        return self._tokenizer.token_to_id(self.unk_token) if i is None else i

    def encode_texts(self, texts):
        """Token ids of each text without special tokens: what
        ``tokenizer(texts, add_special_tokens=False)["input_ids"]`` gives
        on the reference's tokenizer, which turns the backend's
        truncation and padding off for the call."""
        if not texts:
            return []
        self._tokenizer.no_truncation()
        self._tokenizer.no_padding()
        encs = self._tokenizer.encode_batch(list(texts),
                                            add_special_tokens=False)
        return [e.ids for e in encs]


def _add_special_tokens(backend, special, added):
    """Add the config's ``added_tokens_decoder`` entries, then the
    special tokens, where the backend lacks them, as
    ``PreTrainedTokenizerFast.__init__`` adds them."""
    from tokenizers import AddedToken
    have = {str(t.content) for t in
            backend.get_added_tokens_decoder().values()}
    tokens = []
    for entry in added:
        if entry["content"] not in have:
            tokens.append(AddedToken(
                entry["content"], single_word=entry.get("single_word", False),
                lstrip=entry.get("lstrip", False),
                rstrip=entry.get("rstrip", False),
                normalized=entry.get("normalized", True),
                special=entry.get("special", False)))
            have.add(entry["content"])
    for token in special:
        if token not in have:
            tokens.append(AddedToken(token, special=True))
            have.add(token)
    if tokens:
        backend.add_tokens(tokens)


def native_semantics_match(backend, do_lower_case):
    """True iff a ``tokenizers`` backend's configuration is the exact
    pipeline the native engine implements: clean_text + chinese-char
    spacing + NFD accent strip (tied to lowercasing) + lowercase,
    BertPreTokenizer, and '##'-prefixed WordPiece with the standard
    100-char word cap (the reference's ``_native_semantics_match``). Any
    deviation (e.g. strip_accents=False with do_lower_case=True) takes
    the backend instead, rather than change token ids."""
    try:
        model = backend.model
        if type(model).__name__ != "WordPiece":
            return False
        if getattr(model, "continuing_subword_prefix", "##") != "##":
            return False
        if getattr(model, "max_input_chars_per_word", 100) != 100:
            return False
        norm = backend.normalizer
        if type(norm).__name__ != "BertNormalizer":
            return False
        if not getattr(norm, "clean_text", True):
            return False
        if not getattr(norm, "handle_chinese_chars", True):
            return False
        if bool(getattr(norm, "lowercase", do_lower_case)) != do_lower_case:
            return False
        strip = getattr(norm, "strip_accents", None)
        if strip is not None and bool(strip) != do_lower_case:
            return False
        if type(backend.pre_tokenizer).__name__ != "BertPreTokenizer":
            return False
        return True
    except Exception:  # noqa: BLE001 - an unknown backend is not native
        return False


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
