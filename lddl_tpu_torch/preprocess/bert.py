"""BERT pretraining sample construction (NSP pairs + MLM masking).

Counterpart of ``lddl_tpu/preprocess/bert.py``: the same pair creation
(Google BERT's ``create_pretraining_data`` distribution on the frozen
``utils.rng.CounterRNG`` streams), the same static masking and the same
columns, so with ``engine="numpy"`` the port writes the reference's shard
bytes. The pipeline is token-id based: sentences tokenize straight to
ids, pair creation concatenates ids, and static masking runs as one
batched kernel per bucket.

Tokenizer engines (``tokenizer_engine``, as in the reference):

- ``"native"``: the C++ one-pass kernel (split + WordPiece + NSP pairs,
  and on the masked path the masking replay too);
- ``"hf"``: the Python sentence splitter plus one batched call of the
  fast tokenizer's ``tokenizers`` backend (``preprocess.tokenizer``);
- ``"auto"`` (the default): native when the tokenizer's semantics are
  the native engine's (``tokenizer.native_semantics_match``; a vocab
  table always is), else hf.

Unlike the reference, ``auto`` chooses by the tokenizer's semantics and
never by a build failure: a native engine that does not build raises
(``native/build.py``). The two engines give the same bytes wherever both
apply, so this loses nothing of the reference's results.

Masking engines:

- ``engine="numpy"``: the native engine's fused masked kernel, a bit-exact
  C++ replay of ``ops.masking.mask_batch_numpy`` on the Philox stream
  (whole-word masking runs ``mask_whole_word_batch_numpy``); the
  reference's ``LDDL_TPU_NATIVE_FUSED``, ``LDDL_TPU_NATIVE_FUSED_MASK``
  and ``LDDL_TPU_NATIVE_MASK`` pick the staged rungs, with the same bytes
  (``native/__init__.py``);
- ``engine="torch"``: the torch maskers of ``ops.masking`` on
  ``config.device`` (the card unless ``"cpu"``), the counterpart of the
  reference's ``"jax"`` engine: the same pairs, other masks.

Output row schema (the reference sink's):
    A: str                      whitespace-joined WordPiece tokens
    B: str
    is_random_next: bool
    num_tokens: int             len(A) + len(B) + 3 specials
    masked_lm_positions: bytes  (static masking) serialized np array of
                                positions into [CLS] A [SEP] B [SEP]
    masked_lm_labels: str       (static masking) original tokens, joined
plus, in schema v2, the int32 list columns A_ids, B_ids and (masking)
masked_lm_positions_ids, masked_lm_label_ids.
"""

import dataclasses
import hashlib
import itertools
import json

import numpy as np

from .. import observability as obs
from ..ops.masking import (
    make_torch_masker,
    make_torch_whole_word_masker,
    mask_whole_word_batch_numpy,
    plan_num_to_predict,
)
from ..utils import rng as lrng
from .sentences import split_sentences, split_sentences_learned
from .tokenizer import FastBertTokenizer, native_semantics_match


@dataclasses.dataclass
class BertPretrainConfig:
    max_seq_length: int = 128
    short_seq_prob: float = 0.1
    masking: bool = False
    masked_lm_ratio: float = 0.15
    max_predictions_per_seq: int = None  # default: ceil(ratio * max_seq_len)
    whole_word_masking: bool = False
    duplicate_factor: int = 5
    # Static-masking engine: "numpy" (the native Philox replay; shard
    # bytes equal the reference's) or "torch" (the torch maskers on
    # ``device``; the counterpart of the reference's "jax").
    engine: str = "numpy"
    # Sentence-split + tokenize engine: "native" = the C++ one-pass
    # kernel, "hf" = Python splitter + the fast tokenizer's backend,
    # "auto" = native when the tokenizer's semantics are the native
    # engine's, else hf.
    tokenizer_engine: str = "auto"
    # Sentence splitter: "rules" (static rules) or "learned" (corpus-
    # trained punkt parameters; training needs nltk).
    splitter: str = "rules"
    # Shard schema: 2 adds the int32 token-id list columns beside the
    # text columns; 1 keeps text-only shards.
    schema_version: int = 2
    # Device of the "torch" engine (None: the card, see
    # device.resolve_device); unused by "numpy".
    device: str = None

    def __post_init__(self):
        if self.max_seq_length < 8:
            raise ValueError("max_seq_length too small")
        if self.engine not in ("numpy", "torch"):
            raise ValueError("engine must be numpy|torch")
        if self.tokenizer_engine not in ("auto", "hf", "native"):
            raise ValueError("tokenizer_engine must be auto|hf|native")
        if self.splitter not in ("rules", "learned"):
            raise ValueError("splitter must be rules|learned")
        if self.schema_version not in (1, 2):
            raise ValueError("schema_version must be 1|2")
        if self.max_predictions_per_seq is None:
            self.max_predictions_per_seq = int(
                np.ceil(self.masked_lm_ratio * self.max_seq_length))


class _TokenByteTable:
    """Vocab byte tables: ``blob`` = all token UTF-8 bytes concatenated,
    ``starts``/``lens`` per id (the native memcpy join's gather tables)."""

    def __init__(self, enc, starts, lens):
        self.blob = b"".join(enc)
        self.starts = starts
        self.lens = lens


class TokenizerInfo:
    """Pre-extracted tables the id-based pipeline needs, from a tokenizer
    of ``preprocess.tokenizer.get_tokenizer`` (a vocab table or a
    ``FastBertTokenizer``: ``get_vocab()`` and ``do_lower_case``)."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        vocab = tokenizer.get_vocab()
        size = max(vocab.values()) + 1
        id_to_token = [""] * size
        for tok, i in vocab.items():
            id_to_token[i] = tok
        self.id_to_token = np.asarray(id_to_token, dtype=object)
        self.token_list = id_to_token
        self.cls_id = vocab["[CLS]"]
        self.sep_id = vocab["[SEP]"]
        self.mask_id = vocab["[MASK]"]
        self.pad_id = vocab.get("[PAD]", 0)
        self.unk_id = vocab.get("[UNK]", 0)
        self.do_lower_case = bool(getattr(tokenizer, "do_lower_case", True))
        self.vocab_size = size
        self._native = None
        self._hf = None
        self._token_bytes = None
        # Random-replacement masking draws from the full vocab; the
        # subword table supports whole-word masking.
        self.is_subword = np.array(
            [t.startswith("##") for t in id_to_token], dtype=bool)

    def __getstate__(self):
        # The native engine holds a ctypes handle, which cannot cross a
        # pickle boundary: ship only the tokenizer and re-derive the rest.
        return {"tokenizer": self.tokenizer}

    def __setstate__(self, state):
        self.__init__(state["tokenizer"])

    @property
    def vocab_digest(self):
        """Digest of the id->token snapshot this object tokenizes with."""
        d = self.__dict__.get("_vocab_digest")
        if d is None:
            h = hashlib.sha256()
            h.update(b"1" if self.do_lower_case else b"0")
            h.update(json.dumps(self.token_list,
                                separators=(",", ":")).encode())
            d = self._vocab_digest = h.hexdigest()[:16]
        return d

    def token_byte_table(self):
        """Vocab byte tables for the Arrow column builders
        (``preprocess.arrowcols``)."""
        if self._token_bytes is None:
            enc = [t.encode("utf-8") for t in self.token_list]
            lens = np.fromiter(map(len, enc), dtype=np.int64, count=len(enc))
            starts = np.zeros(len(enc), dtype=np.int64)
            np.cumsum(lens[:-1], out=starts[1:])
            self._token_bytes = _TokenByteTable(enc, starts, lens)
        return self._token_bytes

    def native_tokenizer(self):
        """The cached native engine, or None when the tokenizer's backend
        is not the pipeline the native engine implements
        (``native_semantics_match``; a vocab table always is). Built at
        first use; raises when it cannot be built or loaded."""
        if self._native is None:
            backend = getattr(self.tokenizer, "_tokenizer", None)
            if backend is not None and not native_semantics_match(
                    backend, self.do_lower_case):
                self._native = False
            else:
                from .. import native
                unk = (getattr(backend.model, "unk_token", "[UNK]")
                       if backend is not None
                       else getattr(self.tokenizer, "unk_token", "[UNK]"))
                self._native = native.NativeTokenizer(
                    self.token_list,
                    unk_id=self.tokenizer.get_vocab().get(unk, self.unk_id),
                    do_lower_case=self.do_lower_case)
        return self._native or None

    def sentence_ids(self, sentences):
        """Token ids of sentences without special tokens, ``(flat_ids,
        sentence_lens)`` int32: ``native.tokenize_sentences`` where the
        native engine applies, else the fast tokenizer's; what calling
        the reference's tokenizer on them gives either way."""
        nat = self.native_tokenizer()
        if nat is not None:
            from ..native import tokenize_sentences
            return tokenize_sentences(nat, sentences)
        enc = self.hf_tokenizer().encode_texts(sentences)
        lens = np.fromiter(map(len, enc), dtype=np.int32, count=len(enc))
        flat = np.fromiter(itertools.chain.from_iterable(enc),
                           dtype=np.int32, count=int(lens.sum()))
        return flat, lens

    def hf_tokenizer(self):
        """The fast tokenizer of the hf engine: the tokenizer itself when
        it has a backend, else the one ``BertTokenizerFast`` builds from
        the same vocab with the same ``do_lower_case`` (built at first
        use; needs ``tokenizers``)."""
        if self._hf is None:
            if getattr(self.tokenizer, "_tokenizer", None) is not None:
                self._hf = self.tokenizer
            else:
                self._hf = FastBertTokenizer.from_vocab(
                    self.tokenizer.get_vocab(), self.do_lower_case)
        return self._hf


def _tok_info(tokenizer):
    return (tokenizer if isinstance(tokenizer, TokenizerInfo)
            else TokenizerInfo(tokenizer))


def _apply_splitter_params(nat, splitter_params):
    """Attach (or clear) learned splitter params on the cached native
    engine, re-parsing only when the blob actually changed."""
    blob = splitter_params.serialize() if splitter_params else None
    if nat._args[3] != blob:
        nat.set_splitter(blob)


def documents_from_texts(texts, tokenizer, engine="auto",
                         splitter_params=None):
    """Raw document texts -> documents as lists of per-sentence id
    sequences (zero-copy int32 views of the native engine's flat id
    buffer, or Python lists on the hf engine; both iterate and slice
    alike). ``engine`` is a ``tokenizer_engine``; ``splitter_params``
    (sentences.SplitterParams) switches to the corpus-learned punkt
    splitter."""
    tok_info = _tok_info(tokenizer)
    if engine in ("auto", "native"):
        nat = tok_info.native_tokenizer()
        if nat is not None:
            return _documents_from_texts_native(texts, nat, splitter_params)
        if engine == "native":
            raise RuntimeError("the native tokenizer engine does not "
                               "implement this tokenizer's semantics")
    # The pipeline hands document text as raw bytes
    # (readers.read_block_lines); decode here, as the reference does.
    texts = [t.decode("utf-8", errors="replace") if isinstance(t, bytes)
             else t for t in texts]
    if splitter_params is not None:
        doc_sentences = [split_sentences_learned(t, splitter_params)
                         for t in texts]
    else:
        doc_sentences = [split_sentences(t) for t in texts]
    flat = [s for sents in doc_sentences for s in sents]
    if not flat:
        return []
    backend = tok_info.hf_tokenizer().backend_tokenizer
    try:
        encs = backend.encode_batch_fast(flat, add_special_tokens=False)
    except AttributeError:  # tokenizers before 0.21
        encs = backend.encode_batch(flat, add_special_tokens=False)
    all_ids = [e.ids for e in encs]
    documents = []
    k = 0
    for sents in doc_sentences:
        doc = []
        for _ in sents:
            ids = all_ids[k]
            k += 1
            if ids:
                doc.append(ids)
        if doc:
            documents.append(doc)
    return documents


def _documents_from_texts_native(texts, nat, splitter_params):
    _apply_splitter_params(nat, splitter_params)
    ids, sent_lens, doc_counts = nat.tokenize_docs(texts)
    splits = np.split(ids, np.cumsum(sent_lens)[:-1])
    documents = []
    k = 0
    for d in range(len(texts)):
        doc = splits[k:k + int(doc_counts[d])]
        k += int(doc_counts[d])
        if doc:
            documents.append(doc)
    return documents


def _check_splitter(config, splitter_params):
    if config.splitter == "learned" and splitter_params is None:
        raise ValueError(
            "config.splitter='learned' needs splitter_params (see "
            "sentences.train_splitter_params; run_bert_preprocess trains "
            "them automatically)")


def _emit_native_thread_metrics(nat):
    """Pool-attribution metrics after a native kernel call: the configured
    width (``native_threads`` gauge) plus per-thread busy-time deltas
    (``native_thread_busy_seconds_total{tid}``). Together they tell a
    starved pool (every tid busy but wall flat: an oversubscribed host)
    from a serial floor (tid 0 busy, the rest idle: the bucket was too
    small to partition). The kernel's counters are cumulative; the
    previous reading is cached on the tokenizer and diffed here."""
    if not obs.enabled():
        return
    try:
        obs.set_gauge("native_threads", nat.get_threads())
        busy = nat.thread_busy_ns()
        prev = getattr(nat, "_busy_prev", [])
        for t, b in enumerate(busy):
            d = b - (prev[t] if t < len(prev) else 0)
            if d > 0:
                obs.inc("native_thread_busy_seconds_total", d / 1e9,
                        tid=str(t))
        nat._busy_prev = busy
    except Exception:  # noqa: BLE001 - a metrics-only path
        pass


def instances_from_texts(texts, tok_info, config, seed, bucket,
                         splitter_params=None):
    """Texts -> InstanceBatch by ``config.tokenizer_engine``. Native: ONE
    pass (split + WordPiece + NSP pair creation + in-bucket shuffle),
    bit-identical to the staged ``documents_from_texts`` +
    ``pairs_from_documents``; on the unmasked path the kernel also hands
    back the flat A/B id segments. Under ``LDDL_TPU_NATIVE_FUSED=0`` the
    staged native rung (``tokenize_docs`` + ``bert_pairs``) gives the
    same instances. Hf: those two stages in Python on the fast
    tokenizer's ids."""
    tok_info = _tok_info(tok_info)
    _check_splitter(config, splitter_params)
    engine = config.tokenizer_engine
    nat = (tok_info.native_tokenizer()
           if engine in ("auto", "native") else None)
    if engine == "native" and nat is None:
        raise RuntimeError("the native tokenizer engine does not "
                           "implement this tokenizer's semantics")
    if nat is None:
        documents = documents_from_texts(texts, tok_info, engine="hf",
                                         splitter_params=splitter_params)
        instances = pairs_from_documents(documents, config, seed, bucket)
        return InstanceBatch.from_pairs(instances, tok_info.cls_id,
                                        tok_info.sep_id)
    from .. import native
    _apply_splitter_params(nat, splitter_params)
    if not native.fused_enabled():
        # The staged rung (LDDL_TPU_NATIVE_FUSED=0): two native calls,
        # the same instances.
        ids, sent_lens, doc_counts = nat.tokenize_docs(texts)
        seq_ids, seq_lens, a_lens, rn = native.bert_pairs(
            ids, sent_lens, doc_counts, config.max_seq_length,
            config.short_seq_prob, config.duplicate_factor, seed, bucket,
            tok_info.cls_id, tok_info.sep_id)
        _emit_native_thread_metrics(nat)
        return InstanceBatch(seq_ids, seq_lens, a_lens, rn)
    seq_ids, seq_lens, a_lens, rn, a_ids, b_ids = nat.bert_instances(
        texts, config.max_seq_length, config.short_seq_prob,
        config.duplicate_factor, seed, bucket, tok_info.cls_id,
        tok_info.sep_id, want_ab=not config.masking)
    _emit_native_thread_metrics(nat)
    return InstanceBatch(seq_ids, seq_lens, a_lens, rn, a_ids=a_ids,
                         b_ids=b_ids)


# Domain tags of the frozen pair-creation RNG streams (see utils/rng.py:
# CounterRNG — the cross-engine SplitMix64 contract shared with the C++
# engine). One stream per (seed, bucket, duplicate-pass, document); one
# shared stream for the in-bucket instance shuffle.
PAIR_TAG = 0x1DD1_0004
PAIR_SHUFFLE_TAG = 0x1DD1_0005


def _truncate_seq_pair(tokens_a, tokens_b, max_num_tokens, rng):
    """Randomly truncate the longer of A/B from front or back until the pair
    fits; returns the (possibly sliced) pair. One RNG draw per removed
    token, as in the standard algorithm (ref pretrain.py:161-178) — but
    tracked as front/back counters and applied as two slices instead of
    per-token list deletion."""
    la, lb = len(tokens_a), len(tokens_b)
    if la + lb <= max_num_tokens:
        return tokens_a, tokens_b
    fa = ba = fb = bb = 0  # front/back removals of a and b
    while la + lb > max_num_tokens:
        from_a = la > lb
        if (la if from_a else lb) <= 1:
            from_a = not from_a
            if (la if from_a else lb) <= 1:
                break
        if from_a:
            la -= 1
            if rng.uniform() < 0.5:
                fa += 1
            else:
                ba += 1
        else:
            lb -= 1
            if rng.uniform() < 0.5:
                fb += 1
            else:
                bb += 1
    return (tokens_a[fa:len(tokens_a) - ba],
            tokens_b[fb:len(tokens_b) - bb])


def create_pairs_from_document(all_documents, document_index, config, rng):
    """NSP pair instances (unmasked) from one document: list of
    (a_ids, b_ids, is_random_next). ``rng`` is a CounterRNG on the frozen
    cross-engine stream; the native engine replays the identical draw
    sequence (one uniform per decision, one randint per index pick)."""
    document = all_documents[document_index]
    max_num_tokens = config.max_seq_length - 3
    target_seq_length = max_num_tokens
    if rng.uniform() < config.short_seq_prob:
        target_seq_length = rng.randint(2, max_num_tokens + 1)

    instances = []
    current_chunk = []
    current_length = 0
    i = 0
    while i < len(document):
        segment = document[i]
        current_chunk.append(segment)
        current_length += len(segment)
        if i == len(document) - 1 or current_length >= target_seq_length:
            if current_chunk:
                a_end = 1
                if len(current_chunk) >= 2:
                    a_end = rng.randint(1, len(current_chunk))
                tokens_a = []
                for j in range(a_end):
                    tokens_a.extend(current_chunk[j])

                tokens_b = []
                if len(current_chunk) == 1 or rng.uniform() < 0.5:
                    is_random_next = True
                    target_b_length = target_seq_length - len(tokens_a)
                    # Pick a different document (bounded retries mirror the
                    # standard algorithm; degenerate single-doc blocks fall
                    # back to self, kept well-formed by truncation).
                    random_document_index = document_index
                    if len(all_documents) > 1:
                        for _ in range(10):
                            cand = rng.randint(0, len(all_documents))
                            if cand != document_index:
                                random_document_index = cand
                                break
                    random_document = all_documents[random_document_index]
                    random_start = rng.randint(0, len(random_document))
                    for j in range(random_start, len(random_document)):
                        tokens_b.extend(random_document[j])
                        if len(tokens_b) >= target_b_length:
                            break
                    # Put back the unused tail of the chunk.
                    num_unused_segments = len(current_chunk) - a_end
                    i -= num_unused_segments
                else:
                    is_random_next = False
                    for j in range(a_end, len(current_chunk)):
                        tokens_b.extend(current_chunk[j])

                tokens_a, tokens_b = _truncate_seq_pair(
                    tokens_a, tokens_b, max_num_tokens, rng)
                if len(tokens_a) >= 1 and len(tokens_b) >= 1:
                    instances.append((tokens_a, tokens_b, is_random_next))
            current_chunk = []
            current_length = 0
        i += 1
    return instances


def pairs_from_documents(documents, config, seed, bucket):
    """All (a_ids, b_ids, is_random_next) instances for a bucket:
    ``duplicate_factor`` passes over every document, then one in-bucket
    shuffle. Streams are keyed per (seed, bucket, pass, document) so the
    native engine can replay them in any order."""
    instances = []
    for dup in range(config.duplicate_factor):
        for doc_idx in range(len(documents)):
            rng = lrng.CounterRNG(PAIR_TAG, seed, bucket, dup, doc_idx)
            instances.extend(
                create_pairs_from_document(documents, doc_idx, config, rng))
    perm = lrng.stable_shuffle_perm(len(instances), PAIR_SHUFFLE_TAG, seed,
                                    bucket)
    return [instances[i] for i in perm]


@dataclasses.dataclass
class MaskedInstanceBatch:
    """One bucket's instances with static masking ALREADY applied — the
    fused-masked kernel's output format (lddl_bert_instances_masked):
    flat masked A/B id segments plus the row-relative mask selection
    (positions into [CLS] A [SEP] B [SEP], original label ids, per-row
    counts). Everything materialize_columns' masking branch derives from
    the padded matrix arrives precomputed, so no [n, width] array ever
    exists in Python. Bit-exact to apply_static_masking on the same
    Philox stream (held by tests/test_torch_native.py)."""

    a_lens: np.ndarray          # int32 [n]
    seq_lens: np.ndarray        # int32 [n]
    is_random_next: np.ndarray  # bool [n]
    flat_a: np.ndarray          # int32, masked A segments row-major
    flat_b: np.ndarray          # int32, masked B segments row-major
    sel_positions: np.ndarray   # int32, row-relative selected positions
    sel_lens: np.ndarray        # int32 [n] selected count per row
    label_ids: np.ndarray       # int32, original ids at selected positions

    def __len__(self):
        return len(self.seq_lens)


def masked_instances_from_texts(texts, tok_info, config, seed, bucket,
                                mask_scope, splitter_params=None):
    """Raw document bytes -> masked instance arrays in ONE native call
    (split + WordPiece + NSP + shuffle + the numpy-Philox masking replay
    keyed by ``sample_key_bytes(seed, *mask_scope)``).

    Returns a MaskedInstanceBatch, or None outside the replay contract:
    the numpy engine without whole-word masking, vocab size in
    [2, 2^32), the native tokenizer engine; and None when
    ``native.fused_mask_enabled()`` is false (``LDDL_TPU_NATIVE_FUSED=0``,
    ``LDDL_TPU_NATIVE_FUSED_MASK=0`` or ``LDDL_TPU_NATIVE_MASK=0``). The
    caller then takes ``instances_from_texts`` and
    ``apply_static_masking``: the same bytes."""
    if not config.masking or config.whole_word_masking:
        return None
    if config.engine != "numpy":
        return None
    if not (2 <= tok_info.vocab_size < 0xFFFFFFFF):
        return None
    if config.tokenizer_engine not in ("auto", "native"):
        return None
    from .. import native
    if not native.fused_mask_enabled():
        return None
    _check_splitter(config, splitter_params)
    nat = tok_info.native_tokenizer()
    if nat is None:
        return None
    _apply_splitter_params(nat, splitter_params)
    res = nat.bert_instances_masked(
        texts, config.max_seq_length, config.short_seq_prob,
        config.duplicate_factor, seed, bucket, tok_info.cls_id,
        tok_info.sep_id, lrng.sample_key_bytes(seed, *mask_scope),
        tok_info.mask_id, tok_info.vocab_size, config.masked_lm_ratio,
        config.max_predictions_per_seq,
        min(128, config.max_seq_length))
    _emit_native_thread_metrics(nat)
    return MaskedInstanceBatch(*res)


@dataclasses.dataclass
class InstanceBatch:
    """One bucket's pretraining instances in flat array form — the native
    engine's output format; the Python engine converts into it. Row i is
    ``seq_ids[off_i : off_i + seq_lens[i]]`` = [CLS] a [SEP] b [SEP] with
    ``a_lens[i]`` = len(a).

    ``a_ids``/``b_ids`` (optional): the flat A/B segments row-major — the
    fused kernel emits them directly on the unmasked path so the column
    builders skip the fancy-index re-gather; None means "derive from
    seq_ids"."""

    seq_ids: np.ndarray        # int32, all rows concatenated
    seq_lens: np.ndarray       # int32 [n]
    a_lens: np.ndarray         # int32 [n]
    is_random_next: np.ndarray  # bool [n]
    a_ids: np.ndarray = None   # int32, flat A segments (optional)
    b_ids: np.ndarray = None   # int32, flat B segments (optional)

    def __len__(self):
        return len(self.seq_lens)

    @classmethod
    def from_pairs(cls, instances, cls_id, sep_id):
        n = len(instances)
        seq_lens = np.empty(n, dtype=np.int32)
        a_lens = np.empty(n, dtype=np.int32)
        rn = np.empty(n, dtype=bool)
        flat = []
        for i, (a, b, r) in enumerate(instances):
            flat.append(cls_id)
            flat.extend(a)
            flat.append(sep_id)
            flat.extend(b)
            flat.append(sep_id)
            seq_lens[i] = len(a) + len(b) + 3
            a_lens[i] = len(a)
            rn[i] = r
        return cls(np.asarray(flat, dtype=np.int32), seq_lens, a_lens, rn)

    def padded(self, pad_id, length_multiple, min_length):
        """(ids, valid) 2-D arrays, width padded up to a lane-aligned
        bucket so jit compilations stay bounded."""
        from ..ops.packing import round_up
        n = len(self)
        width = max(min_length,
                    round_up(int(self.seq_lens.max()), length_multiple))
        valid = np.arange(width)[None, :] < self.seq_lens[:, None]
        ids = np.full((n, width), pad_id, dtype=np.int32)
        ids[valid] = self.seq_ids  # row-major fill matches flat order
        return ids, valid


def _candidate_mask(valid, a_lens, seq_lens):
    """Positions eligible for masking: valid, not [CLS]/[SEP]."""
    candidate = valid.copy()
    rows = np.arange(valid.shape[0])
    candidate[:, 0] = False
    candidate[rows, a_lens + 1] = False
    candidate[rows, seq_lens - 1] = False
    return candidate


def apply_static_masking(batch, config, tok_info, seed, scope):
    """Batch-mask all instances of a bucket (an InstanceBatch or a list of
    (a, b, is_random_next) pairs); returns batch arrays (masked ids,
    selected mask, original ids, a_lens, seq_lens).

    Engine "numpy": the native replay of ``mask_batch_numpy`` on the
    Philox stream of ``sample_rng(seed, *scope)`` (whole-word masking:
    ``mask_whole_word_batch_numpy`` on that stream). Engine "torch": the
    torch maskers on ``config.device``, in row chunks
    (``_run_torch_chunked``)."""
    if isinstance(batch, list):
        batch = InstanceBatch.from_pairs(batch, tok_info.cls_id,
                                         tok_info.sep_id)
    a_lens, seq_lens = batch.a_lens, batch.seq_lens
    width = min(128, config.max_seq_length)
    ids, valid = batch.padded(tok_info.pad_id, width, width)
    candidate = _candidate_mask(valid, a_lens, seq_lens)
    num_to_predict = plan_num_to_predict(seq_lens, config.masked_lm_ratio,
                                         config.max_predictions_per_seq)

    if config.engine == "torch":
        masker = (_get_torch_wwm_masker(tok_info, config.device)
                  if config.whole_word_masking
                  else _get_torch_masker(tok_info, config.device))
        masked, selected = _run_torch_chunked(masker, ids, candidate,
                                              num_to_predict, seed, scope)
    elif config.whole_word_masking:
        masked, selected = mask_whole_word_batch_numpy(
            ids, candidate, num_to_predict, lrng.sample_rng(seed, *scope),
            tok_info.mask_id, tok_info.vocab_size, tok_info.is_subword)
    else:
        from .. import native
        masked_selected = native.mask_batch(
            lrng.sample_key_bytes(seed, *scope), ids, candidate,
            num_to_predict, tok_info.mask_id, tok_info.vocab_size)
        # None: vocab size outside the replay, or LDDL_TPU_NATIVE_MASK=0.
        if masked_selected is None:
            from ..ops.masking import mask_batch_numpy
            masked_selected = mask_batch_numpy(
                ids, candidate, num_to_predict,
                lrng.sample_rng(seed, *scope), tok_info.mask_id,
                tok_info.vocab_size)
        masked, selected = masked_selected

    return masked, selected, ids, a_lens, seq_lens


# Rows per torch masker call: bounds the device memory one call takes.
TORCH_MASK_CHUNK = 2048


def torch_mask_seed(seed, scope):
    """The one 64-bit seed of a bucket's torch masks: blake2b of (seed,
    scope)."""
    digest = hashlib.blake2b("{}:{}".format(seed, scope).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little")


def _run_torch_chunked(masker, ids, candidate, num_to_predict, seed, scope):
    """Run a torch masker over fixed-size row chunks. The counter hash is
    keyed by one seed per bucket and by each row's global index, so the
    masks do not depend on the chunking (the reference instead seeds each
    chunk of its jit'd masker and pads the last one to bound
    compilations; torch compiles nothing, so nothing is padded)."""
    n = ids.shape[0]
    if n == 0:
        return ids.copy(), np.zeros_like(candidate)
    mask_seed = torch_mask_seed(seed, scope)
    masked_parts, selected_parts = [], []
    for start in range(0, n, TORCH_MASK_CHUNK):
        end = start + TORCH_MASK_CHUNK
        m_c, s_c = masker(ids[start:end], candidate[start:end],
                          num_to_predict[start:end], mask_seed,
                          row_offset=start)
        masked_parts.append(m_c)
        selected_parts.append(s_c)
    return np.concatenate(masked_parts), np.concatenate(selected_parts)


_TORCH_MASKERS = {}


def _get_torch_masker(tok_info, device):
    key = (tok_info.mask_id, tok_info.vocab_size, device)
    if key not in _TORCH_MASKERS:
        _TORCH_MASKERS[key] = make_torch_masker(
            tok_info.mask_id, tok_info.vocab_size, device=device)
    return _TORCH_MASKERS[key]


def _get_torch_wwm_masker(tok_info, device):
    # is_subword is part of the key: two vocabs of the same size and
    # mask_id can group words differently.
    key = (tok_info.mask_id, tok_info.vocab_size,
           tok_info.is_subword.tobytes(), device)
    if key not in _TORCH_MASKERS:
        _TORCH_MASKERS[key] = make_torch_whole_word_masker(
            tok_info.mask_id, tok_info.vocab_size, tok_info.is_subword,
            device=device)
    return _TORCH_MASKERS[key]


def materialize_columns(batch, config, tok_info, seed, scope):
    """Instances (InstanceBatch or list of (a, b, is_random_next)) ->
    parquet COLUMNS ({name: ndarray-or-pa.Array}, n), applying static
    masking batch-wise when configured.

    Columnar end-to-end: the string/binary columns are assembled as raw
    Arrow buffers with vectorized byte gathers (preprocess.arrowcols) —
    between pair construction and the parquet file, no per-row Python
    object exists at all."""
    from .arrowcols import (concat_aranges, int32_list_array,
                            joined_token_strings, serialized_u16_binary)
    if isinstance(batch, list):
        batch = InstanceBatch.from_pairs(batch, tok_info.cls_id,
                                         tok_info.sep_id)
    n = len(batch)
    if n == 0:
        return {}, 0
    if isinstance(batch, MaskedInstanceBatch):
        # Fused-masked fast path: the kernel already applied the Philox
        # masking replay and emitted exactly the flat arrays the column
        # builders consume — same values the padded-matrix branch below
        # would gather, so shard bytes are identical by construction.
        tok_table = tok_info.token_byte_table()
        a_lens = np.asarray(batch.a_lens, dtype=np.int64)
        b_lens = np.asarray(batch.seq_lens, dtype=np.int64) - a_lens - 3
        sel_lens = np.asarray(batch.sel_lens, dtype=np.int64)
        columns = {
            "A": joined_token_strings(batch.flat_a, a_lens, tok_table),
            "B": joined_token_strings(batch.flat_b, b_lens, tok_table),
            "is_random_next": np.asarray(batch.is_random_next, dtype=bool),
            "num_tokens": np.asarray(batch.seq_lens).astype(np.uint16),
            "masked_lm_positions": serialized_u16_binary(
                batch.sel_positions, sel_lens),
            "masked_lm_labels": joined_token_strings(
                batch.label_ids, sel_lens, tok_table),
        }
        if config.schema_version >= 2:
            columns["A_ids"] = int32_list_array(batch.flat_a, a_lens)
            columns["B_ids"] = int32_list_array(batch.flat_b, b_lens)
            columns["masked_lm_positions_ids"] = int32_list_array(
                batch.sel_positions, sel_lens)
            columns["masked_lm_label_ids"] = int32_list_array(
                batch.label_ids, sel_lens)
        return columns, n
    tok_table = tok_info.token_byte_table()
    a_lens = np.asarray(batch.a_lens, dtype=np.int64)
    seq_lens = np.asarray(batch.seq_lens, dtype=np.int64)
    b_lens = seq_lens - a_lens - 3
    rn = batch.is_random_next

    if not config.masking:
        if batch.a_ids is not None and batch.b_ids is not None:
            # Fused-kernel fast path: the flat A/B segments arrived as
            # ownership-transferred buffers — wrap, don't re-gather.
            flat_a, flat_b = batch.a_ids, batch.b_ids
        else:
            # Row i of seq_ids spans [off_i, off_i + seq_lens_i):
            # [CLS] A [SEP] B [SEP]. Gather A and B id segments flat.
            offsets = np.cumsum(seq_lens) - seq_lens
            flat_a = batch.seq_ids[np.repeat(offsets + 1, a_lens)
                                   + concat_aranges(a_lens)]
            flat_b = batch.seq_ids[np.repeat(offsets + 2 + a_lens, b_lens)
                                   + concat_aranges(b_lens)]
        columns = {
            "A": joined_token_strings(flat_a, a_lens, tok_table),
            "B": joined_token_strings(flat_b, b_lens, tok_table),
            "is_random_next": np.asarray(rn, dtype=bool),
            "num_tokens": seq_lens.astype(np.uint16),
        }
        if config.schema_version >= 2:
            columns["A_ids"] = int32_list_array(flat_a, a_lens)
            columns["B_ids"] = int32_list_array(flat_b, b_lens)
        return columns, n

    masked, selected, ids, a_lens, seq_lens = apply_static_masking(
        batch, config, tok_info, seed, scope)
    a_lens = np.asarray(a_lens, dtype=np.int64)
    seq_lens = np.asarray(seq_lens, dtype=np.int64)
    b_lens = seq_lens - a_lens - 3
    rows = np.arange(n, dtype=np.int64)
    flat_a = masked[np.repeat(rows, a_lens),
                    1 + concat_aranges(a_lens)]
    flat_b = masked[np.repeat(rows, b_lens),
                    np.repeat(2 + a_lens, b_lens) + concat_aranges(b_lens)]
    sel_rows, sel_cols = np.nonzero(selected)            # row-major: sorted
    sel_lens = np.bincount(sel_rows, minlength=n)
    columns = {
        "A": joined_token_strings(flat_a, a_lens, tok_table),
        "B": joined_token_strings(flat_b, b_lens, tok_table),
        "is_random_next": np.asarray(rn, dtype=bool),
        "num_tokens": seq_lens.astype(np.uint16),
        "masked_lm_positions": serialized_u16_binary(sel_cols, sel_lens),
        "masked_lm_labels": joined_token_strings(
            ids[sel_rows, sel_cols], sel_lens, tok_table),
    }
    if config.schema_version >= 2:
        columns["A_ids"] = int32_list_array(flat_a, a_lens)
        columns["B_ids"] = int32_list_array(flat_b, b_lens)
        columns["masked_lm_positions_ids"] = int32_list_array(sel_cols,
                                                              sel_lens)
        columns["masked_lm_label_ids"] = int32_list_array(
            ids[sel_rows, sel_cols], sel_lens)
    return columns, n


def materialize_rows(batch, config, tok_info, seed, scope):
    """Row-dict view of materialize_columns (debug/txt sink + tests; the
    parquet path consumes the columns directly)."""
    import pyarrow as pa
    # The schema-v2 id columns are a loader fast path, not part of the
    # human-readable row view (txt sink format is schema-stable) — don't
    # build them just to drop them.
    if config.schema_version != 1:
        config = dataclasses.replace(config, schema_version=1)
    columns, n = materialize_columns(batch, config, tok_info, seed, scope)
    plain = {
        # Debug/test row view only (see docstring): the parquet path
        # consumes the columns directly and never takes this branch.
        name: (col.to_pylist() if isinstance(col, pa.Array)  # lddl: disable=python-hot-loop
               else col.tolist())  # lddl: disable=python-hot-loop
        for name, col in columns.items()
    }
    names = list(plain)
    return [{name: plain[name][i] for name in names} for i in range(n)]
