"""ctypes binding for the native preprocessing engine.

The port's own copy of ``lddl_tpu/native/__init__.py`` over its own copy
of the C++ source (``lddl_native.cpp``, built by ``build.py``). Public
surface:
    NativeTokenizer(id_to_token, unk_id, do_lower_case)
        .tokenize_docs(texts) -> (ids, sent_lens, doc_sent_counts) np arrays
        .bert_instances(docs, ...) -> packed instance arrays in ONE pass
        .bert_instances_masked(docs, ...) -> the same, statically masked
    tokenize_sentences(tokenizer, sentences) -> (ids, sentence_lens)
    segment_sums(values, counts) -> sums of consecutive runs
    bert_pairs(...)  -> NSP pairs over tokenize_docs output (staged rung)
    mask_batch(key, ids, candidate, ...) -> numpy-Philox-replay masking
    join_tokens(...) -> space-joined token strings as Arrow buffers
    split_docs(texts) -> list[list[str]]   (sentence split only)

Rungs, chosen by the reference's environment variables, each read per
call (spawned pool workers inherit them):

    fused-masked   ``bert_instances_masked``: split + WordPiece + NSP +
                   shuffle + the masking replay in one call (the default
                   on the masked path)
    fused          ``bert_instances`` (+ ``mask_batch`` when masking):
                   ``LDDL_TPU_NATIVE_FUSED_MASK=0`` or
                   ``LDDL_TPU_NATIVE_MASK=0`` (``fused_mask_enabled``)
    staged         ``tokenize_docs`` + ``bert_pairs``:
                   ``LDDL_TPU_NATIVE_FUSED=0`` (``fused_enabled``)
    numpy masking  ``LDDL_TPU_NATIVE_MASK=0``: ``mask_batch`` returns None
                   and the caller masks with ``ops.masking.mask_batch_numpy``

Every rung gives the same bytes. Unlike the reference, these are
explicit choices and nothing else: the library builds at first use under
every setting, any failure to build or load raises, and the preprocess
never moves to another rung, or to the hf engine, on its own. The other
environment variables read are ``LDDL_TPU_NATIVE_THREADS``, the
in-kernel thread budget the preprocess runner hands its spawned workers,
``LDDL_TPU_NATIVE_SANITIZE``, the sanitizer modes of the build
(``build.sanitize_modes``; a sanitized library that does not load
because its runtime is not preloaded raises and names ``LD_PRELOAD``),
and ``LDDL_TPU_NATIVE_MARCH``, the build's ``-march``
(``build.compile_flags``).

The library is loaded from its own path with ctypes' default
``RTLD_LOCAL``, so it stays apart from the reference's library of the
same symbols when both are loaded in one process (the parity tests).

Zero-copy result contract: the kernels malloc exactly-sized output buffers
and transfer ownership — the binding wraps each buffer as a numpy array
whose finalizer (weakref.finalize -> lddl_buf_free) frees it when the last
view dies. No ``.copy()`` ever happens at the boundary.
"""

import ctypes
import os
import threading
import weakref

import numpy as np

_lock = threading.Lock()
_lib = None


class _TokResult(ctypes.Structure):
    _fields_ = [
        ("ids", ctypes.POINTER(ctypes.c_int32)),
        ("n_ids", ctypes.c_int64),
        ("sent_lens", ctypes.POINTER(ctypes.c_int32)),
        ("n_sents", ctypes.c_int64),
        ("doc_sent_counts", ctypes.POINTER(ctypes.c_int32)),
        ("n_docs", ctypes.c_int64),
    ]


class _PairResult(ctypes.Structure):
    _fields_ = [
        ("seq_ids", ctypes.POINTER(ctypes.c_int32)),
        ("n_seq_ids", ctypes.c_int64),
        ("seq_lens", ctypes.POINTER(ctypes.c_int32)),
        ("a_lens", ctypes.POINTER(ctypes.c_int32)),
        ("is_random_next", ctypes.POINTER(ctypes.c_uint8)),
        ("n_instances", ctypes.c_int64),
    ]


class _SplitResult(ctypes.Structure):
    _fields_ = [
        ("starts", ctypes.POINTER(ctypes.c_int64)),
        ("ends", ctypes.POINTER(ctypes.c_int64)),
        ("n_sents", ctypes.c_int64),
        ("doc_sent_counts", ctypes.POINTER(ctypes.c_int32)),
        ("n_docs", ctypes.c_int64),
    ]


class _InstResult(ctypes.Structure):
    _fields_ = [
        ("seq_ids", ctypes.POINTER(ctypes.c_int32)),
        ("n_seq_ids", ctypes.c_int64),
        ("seq_lens", ctypes.POINTER(ctypes.c_int32)),
        ("a_lens", ctypes.POINTER(ctypes.c_int32)),
        ("is_random_next", ctypes.POINTER(ctypes.c_uint8)),
        ("n_instances", ctypes.c_int64),
        ("a_ids", ctypes.POINTER(ctypes.c_int32)),
        ("n_a_ids", ctypes.c_int64),
        ("b_ids", ctypes.POINTER(ctypes.c_int32)),
        ("n_b_ids", ctypes.c_int64),
    ]


class _MaskedInstResult(ctypes.Structure):
    _fields_ = [
        ("a_lens", ctypes.POINTER(ctypes.c_int32)),
        ("seq_lens", ctypes.POINTER(ctypes.c_int32)),
        ("is_random_next", ctypes.POINTER(ctypes.c_uint8)),
        ("n_instances", ctypes.c_int64),
        ("a_ids", ctypes.POINTER(ctypes.c_int32)),
        ("n_a_ids", ctypes.c_int64),
        ("b_ids", ctypes.POINTER(ctypes.c_int32)),
        ("n_b_ids", ctypes.c_int64),
        ("mlm_pos", ctypes.POINTER(ctypes.c_int32)),
        ("mlm_labels", ctypes.POINTER(ctypes.c_int32)),
        ("mlm_lens", ctypes.POINTER(ctypes.c_int32)),
        ("n_mlm", ctypes.c_int64),
    ]


def _load():
    """The loaded library (built at first use); raises when it cannot be
    built or loaded, or when its ABI is not the one bound here."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from .build import ensure_built, sanitize_modes
        path = ensure_built()
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            modes = sanitize_modes()
            if not modes:
                raise
            # A tsan/asan library loads into Python only with its
            # sanitizer's runtime preloaded; never a missing engine.
            raise RuntimeError(
                "the native engine built with LDDL_TPU_NATIVE_SANITIZE={} "
                "did not load ({}); run Python with the sanitizer runtime "
                "in LD_PRELOAD (e.g. LD_PRELOAD=$(g++ "
                "-print-file-name=libtsan.so))".format(
                    ",".join(modes), e)) from e
        abi = lib.lddl_native_abi_version()
        if abi != 8:
            raise RuntimeError("native engine ABI {} != 8".format(abi))
        lib.lddl_tok_create.restype = ctypes.c_void_p
        lib.lddl_tok_create.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                        ctypes.c_int32, ctypes.c_int]
        lib.lddl_tok_free.argtypes = [ctypes.c_void_p]
        lib.lddl_tok_set_threads.restype = None
        lib.lddl_tok_set_threads.argtypes = [ctypes.c_void_p,
                                             ctypes.c_int32]
        lib.lddl_tok_get_threads.restype = ctypes.c_int32
        lib.lddl_tok_get_threads.argtypes = [ctypes.c_void_p]
        lib.lddl_tok_thread_busy_ns.restype = ctypes.c_int32
        lib.lddl_tok_thread_busy_ns.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int32]
        lib.lddl_tok_set_splitter.restype = None
        lib.lddl_tok_set_splitter.argtypes = [ctypes.c_void_p,
                                              ctypes.c_char_p,
                                              ctypes.c_int64]
        lib.lddl_join_tokens.restype = None
        lib.lddl_join_tokens.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32)]
        lib.lddl_tok_docs.restype = ctypes.POINTER(_TokResult)
        lib.lddl_tok_docs.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        lib.lddl_tok_result_free.argtypes = [ctypes.POINTER(_TokResult)]
        lib.lddl_split_result_free.argtypes = [ctypes.POINTER(_SplitResult)]
        lib.lddl_bert_pairs.restype = ctypes.POINTER(_PairResult)
        lib.lddl_bert_pairs.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_double, ctypes.c_int32,
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32]
        lib.lddl_pairs_free.argtypes = [ctypes.POINTER(_PairResult)]
        lib.lddl_buf_free.argtypes = [ctypes.c_void_p]
        lib.lddl_bert_instances.restype = ctypes.POINTER(_InstResult)
        lib.lddl_bert_instances.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int32, ctypes.c_double, ctypes.c_int32,
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32]
        lib.lddl_inst_free.argtypes = [ctypes.POINTER(_InstResult)]
        lib.lddl_mask_batch.restype = None
        lib.lddl_mask_batch.argtypes = [
            ctypes.c_uint64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32]
        lib.lddl_split_docs_spans.restype = ctypes.POINTER(_SplitResult)
        lib.lddl_split_docs_spans.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32]
        lib.lddl_bert_instances_masked.restype = \
            ctypes.POINTER(_MaskedInstResult)
        lib.lddl_bert_instances_masked.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int32, ctypes.c_double, ctypes.c_int32,
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_double, ctypes.c_int32, ctypes.c_int32]
        lib.lddl_masked_inst_free.argtypes = [
            ctypes.POINTER(_MaskedInstResult)]
        _lib = lib
        return _lib


def fused_enabled():
    """False under ``LDDL_TPU_NATIVE_FUSED=0``: the preprocess then takes
    the staged rung (``tokenize_docs`` + ``bert_pairs``, two calls)."""
    return os.environ.get("LDDL_TPU_NATIVE_FUSED", "1") != "0"


def mask_enabled():
    """False under ``LDDL_TPU_NATIVE_MASK=0``: no C++ masking anywhere
    (``mask_batch`` returns None, and the fused-masked rung is off)."""
    return os.environ.get("LDDL_TPU_NATIVE_MASK") != "0"


def fused_mask_enabled():
    """True when the fused-masked rung may run: the fused rung is on and
    neither ``LDDL_TPU_NATIVE_FUSED_MASK=0`` nor
    ``LDDL_TPU_NATIVE_MASK=0`` is set (the latter must give numpy
    masking, not the fused replay of it). Otherwise the masked path
    takes fused-unmasked + ``mask_batch``."""
    return (fused_enabled()
            and os.environ.get("LDDL_TPU_NATIVE_FUSED_MASK", "1") != "0"
            and mask_enabled())


_MAX_THREADS = 64  # kMaxThreads in lddl_native.cpp


def resolve_threads(requested=None):
    """Effective in-kernel thread count (the v8 thread pool).

    Precedence: explicit ``requested`` > ``LDDL_TPU_NATIVE_THREADS`` env
    (``0`` or ``auto`` -> the process's usable-CPU count; unset/empty/
    unparsable -> 1). Clamped to [1, 64] (the kernel's kMaxThreads). Read
    per call so spawned pool workers — which inherit the environment the
    runner sized for them — resolve their own budget."""
    if requested is None:
        raw = os.environ.get("LDDL_TPU_NATIVE_THREADS", "").strip().lower()
        if raw in ("0", "auto"):
            from ..utils.cpus import usable_cpu_count
            requested = usable_cpu_count()
        else:
            try:
                requested = int(raw) if raw else 1
            except ValueError:
                requested = 1
    return max(1, min(_MAX_THREADS, int(requested)))


def _owned_array(lib, ptr, n, ctype, dtype):
    """Wrap a malloc'd kernel buffer as a numpy array WITHOUT copying;
    ownership transfers to the array — a finalizer frees the buffer when
    the array (and every view holding a base reference to it) is gone.

    Exception-safety contract with the result structs: the caller nulls
    the struct field right after this returns and always calls the
    kernel's ``*_free`` in a ``finally`` — so a failure mid-wrap frees
    exactly the not-yet-transferred buffers (free(NULL) is a no-op for
    the transferred ones) and the struct itself, never double-freeing."""
    addr = ctypes.cast(ptr, ctypes.c_void_p).value
    if not n or not addr:
        if addr:
            lib.lddl_buf_free(addr)
        return np.zeros(0, dtype=dtype)
    arr = np.ctypeslib.as_array(ctypes.cast(addr, ctypes.POINTER(ctype)),
                                shape=(int(n),))
    weakref.finalize(arr, lib.lddl_buf_free, addr)
    return arr


def _doc_ranges(docs):
    """(buf, starts, ends, n, keepalive) for the native kernels.

    ``docs`` is either a zero-copy span view (readers.DocSpans duck type:
    ``.buffer``/``.starts``/``.ends``) — no bytes are touched — or any
    sequence of bytes/str, which packs into one contiguous buffer."""
    buffer = getattr(docs, "buffer", None)
    if buffer is not None:
        starts = np.ascontiguousarray(docs.starts, dtype=np.int64)
        ends = np.ascontiguousarray(docs.ends, dtype=np.int64)
        return buffer, starts, ends, len(starts), (starts, ends)
    buf, offsets = _pack_docs(docs)
    return buf, offsets[:-1], offsets[1:], len(docs), (offsets,)


def join_tokens(flat_ids, row_lens, blob, tok_starts, tok_lens,
                total_bytes):
    """Space-join token ids into one contiguous UTF-8 buffer + int32 value
    offsets (the Arrow StringArray layout) with the C memcpy kernel.
    Returns (data uint8[total_bytes], offsets int32[n_rows+1])."""
    lib = _load()
    flat_ids = np.ascontiguousarray(flat_ids, dtype=np.int32)
    row_lens = np.ascontiguousarray(row_lens, dtype=np.int64)
    tok_starts = np.ascontiguousarray(tok_starts, dtype=np.int64)
    tok_lens = np.ascontiguousarray(tok_lens, dtype=np.int64)
    out = np.empty(int(total_bytes), dtype=np.uint8)
    offsets = np.empty(len(row_lens) + 1, dtype=np.int32)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    lib.lddl_join_tokens(
        flat_ids.ctypes.data_as(p_i32), len(flat_ids),
        row_lens.ctypes.data_as(p_i64), len(row_lens),
        blob,
        tok_starts.ctypes.data_as(p_i64),
        tok_lens.ctypes.data_as(p_i64),
        out.ctypes.data_as(ctypes.c_char_p),
        offsets.ctypes.data_as(p_i32))
    return out, offsets


def _pack_docs(texts):
    """Concatenate texts into one UTF-8 buffer + int64 offsets array.
    Accepts bytes (the preprocess pipeline's zero-decode path — the C++
    engine is the first and only UTF-8 decoder) or str."""
    encoded = [t if isinstance(t, bytes) else t.encode("utf-8")
               for t in texts]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    return b"".join(encoded), offsets


class NativeTokenizer:
    """Native split+normalize+WordPiece over documents.

    One instance holds the vocab hash table and the word->ids memo cache;
    reuse it across buckets (the memo is what makes Zipf-distributed text
    fast). Not thread-safe; use one instance per worker process.
    """

    def __init__(self, id_to_token, unk_id, do_lower_case=True,
                 splitter_blob=None):
        lib = _load()
        self._args = (list(id_to_token), int(unk_id), bool(do_lower_case),
                      splitter_blob)
        self._lib = lib
        buf = "\n".join(id_to_token).encode("utf-8")
        self._handle = lib.lddl_tok_create(buf, len(buf), int(unk_id),
                                           1 if do_lower_case else 0)
        if splitter_blob:
            lib.lddl_tok_set_splitter(self._handle, splitter_blob,
                                      len(splitter_blob))
        # Thread budget is resolved from the environment, NOT pickled in
        # _args: a pool worker rebuilding the tokenizer sizes itself from
        # the env the runner set for it, not from the parent's budget.
        lib.lddl_tok_set_threads(self._handle, resolve_threads())

    def set_threads(self, n):
        """Resize the in-kernel thread pool (clamped to [1, 64])."""
        self._lib.lddl_tok_set_threads(self._handle, int(n))

    def get_threads(self):
        """Configured pool width (a bucket with fewer docs runs narrower)."""
        return int(self._lib.lddl_tok_get_threads(self._handle))

    def thread_busy_ns(self):
        """Cumulative per-thread busy nanoseconds since construction, one
        entry per configured thread slot (the ``native_thread_busy_
        seconds_total{tid}`` counter diffs successive reads)."""
        out = (ctypes.c_int64 * _MAX_THREADS)()
        n = self._lib.lddl_tok_thread_busy_ns(self._handle, out,
                                              _MAX_THREADS)
        return [int(out[i]) for i in range(max(0, n))]

    def set_splitter(self, blob):
        """Attach (or clear, blob=None) corpus-learned punkt splitter
        params — the SplitterParams.serialize() blob (never empty: it
        carries a 'P1' header line, so clear-vs-params is unambiguous).
        tokenize_docs then splits with the learned decision procedure."""
        self._lib.lddl_tok_set_splitter(self._handle, blob or b"",
                                        len(blob or b""))
        self._args = self._args[:3] + (blob,)

    def __reduce__(self):
        # ctypes handles cannot cross pickle boundaries; rebuild from the
        # constructor args in the receiving process (fresh memo cache).
        return (NativeTokenizer, self._args)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.lddl_tok_free(self._handle)
            self._handle = None

    def tokenize_docs(self, texts):
        """-> (ids int32[], sent_lens int32[], doc_sent_counts int32[]).

        Sentences are concatenated in document order; empty sentences are
        dropped; doc_sent_counts[d] = number of non-empty sentences of
        document d. The returned arrays wrap the kernel's buffers without
        copying (ownership transfers; a finalizer frees each buffer).
        """
        if not len(texts):
            z = np.zeros(0, dtype=np.int32)
            return z, z.copy(), z.copy()
        lib = self._lib
        buf, offsets = _pack_docs(texts)
        res = lib.lddl_tok_docs(
            self._handle, buf,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(texts))
        try:
            r = res.contents
            ids = _owned_array(lib, r.ids, r.n_ids, ctypes.c_int32,
                               np.int32)
            r.ids = None
            sent_lens = _owned_array(lib, r.sent_lens, r.n_sents,
                                     ctypes.c_int32, np.int32)
            r.sent_lens = None
            doc_counts = _owned_array(lib, r.doc_sent_counts, r.n_docs,
                                      ctypes.c_int32, np.int32)
            r.doc_sent_counts = None
        finally:
            # Frees whatever was NOT transferred (nulled fields are
            # free(NULL) no-ops) plus the struct — leak-free even when a
            # wrap raises mid-way.
            lib.lddl_tok_result_free(res)
        return ids, sent_lens, doc_counts

    def bert_instances(self, docs, max_seq_length, short_seq_prob,
                       duplicate_factor, seed, bucket, cls_id, sep_id,
                       want_ab=False):
        """FUSED hot path: documents -> packed NSP instance arrays in one
        native pass (split + normalize + WordPiece + pair creation +
        in-bucket shuffle), bit-identical to tokenize_docs + bert_pairs.

        ``docs`` is a readers.DocSpans view (zero-copy: the kernel reads
        the spool buffer in place) or a sequence of bytes/str. Returns
        (seq_ids, seq_lens, a_lens, is_random_next, a_ids, b_ids) numpy
        arrays wrapping the kernel's buffers without copying; a_ids/b_ids
        are None unless ``want_ab``.
        """
        lib = self._lib
        if not len(docs):
            z = np.zeros(0, dtype=np.int32)
            empty_ab = z.copy() if want_ab else None
            return (z, z.copy(), z.copy(), np.zeros(0, dtype=bool),
                    empty_ab, z.copy() if want_ab else None)
        buf, starts, ends, n, _keep = _doc_ranges(docs)
        p_i64 = ctypes.POINTER(ctypes.c_int64)
        res = lib.lddl_bert_instances(
            self._handle, buf,
            starts.ctypes.data_as(p_i64), ends.ctypes.data_as(p_i64),
            n, int(max_seq_length), float(short_seq_prob),
            int(duplicate_factor), int(seed) & (2**64 - 1),
            int(bucket) & (2**64 - 1), int(cls_id), int(sep_id),
            1 if want_ab else 0)
        try:
            r = res.contents
            n_inst = r.n_instances
            seq_ids = _owned_array(lib, r.seq_ids, r.n_seq_ids,
                                   ctypes.c_int32, np.int32)
            r.seq_ids = None
            seq_lens = _owned_array(lib, r.seq_lens, n_inst,
                                    ctypes.c_int32, np.int32)
            r.seq_lens = None
            a_lens = _owned_array(lib, r.a_lens, n_inst,
                                  ctypes.c_int32, np.int32)
            r.a_lens = None
            rn = _owned_array(lib, r.is_random_next, n_inst,
                              ctypes.c_uint8, np.uint8).view(np.bool_)
            r.is_random_next = None
            a_ids = b_ids = None
            if want_ab:
                a_ids = _owned_array(lib, r.a_ids, r.n_a_ids,
                                     ctypes.c_int32, np.int32)
                r.a_ids = None
                b_ids = _owned_array(lib, r.b_ids, r.n_b_ids,
                                     ctypes.c_int32, np.int32)
                r.b_ids = None
        finally:
            lib.lddl_inst_free(res)  # see tokenize_docs: leak-free
        return seq_ids, seq_lens, a_lens, rn, a_ids, b_ids

    def bert_instances_masked(self, docs, max_seq_length, short_seq_prob,
                              duplicate_factor, seed, bucket, cls_id,
                              sep_id, key_bytes, mask_id, vocab_size,
                              masked_lm_ratio, max_predictions, width_min):
        """FUSED-MASKED hot path: documents -> MASKED instance arrays in
        one native pass — everything bert_instances does PLUS the
        bit-exact numpy-Philox masking replay over the (virtual) padded
        matrix the staged path would build (key = ``key_bytes`` from
        utils.rng.sample_key_bytes; same draw-order contract as
        mask_batch). Returns (a_lens, seq_lens, is_random_next, flat_a,
        flat_b, sel_positions, sel_lens, label_ids) — masked A/B id
        segments plus the row-relative mask selection — or None when the
        parameters fall outside the frozen replay contract (vocab size
        must be in [2, 2^32))."""
        vocab_size = int(vocab_size)
        if not (2 <= vocab_size < 0xFFFFFFFF):
            return None
        lib = self._lib
        z = np.zeros(0, dtype=np.int32)
        if not len(docs):
            return (z, z.copy(), np.zeros(0, dtype=bool), z.copy(),
                    z.copy(), z.copy(), z.copy(), z.copy())
        buf, starts, ends, n, _keep = _doc_ranges(docs)
        k0, k1 = np.frombuffer(key_bytes, dtype="<u8")
        p_i64 = ctypes.POINTER(ctypes.c_int64)
        res = lib.lddl_bert_instances_masked(
            self._handle, buf,
            starts.ctypes.data_as(p_i64), ends.ctypes.data_as(p_i64),
            n, int(max_seq_length), float(short_seq_prob),
            int(duplicate_factor), int(seed) & (2**64 - 1),
            int(bucket) & (2**64 - 1), int(cls_id), int(sep_id),
            int(k0), int(k1), int(mask_id), vocab_size,
            float(masked_lm_ratio), int(max_predictions), int(width_min))
        try:
            r = res.contents
            n_inst = r.n_instances
            a_lens = _owned_array(lib, r.a_lens, n_inst,
                                  ctypes.c_int32, np.int32)
            r.a_lens = None
            seq_lens = _owned_array(lib, r.seq_lens, n_inst,
                                    ctypes.c_int32, np.int32)
            r.seq_lens = None
            rn = _owned_array(lib, r.is_random_next, n_inst,
                              ctypes.c_uint8, np.uint8).view(np.bool_)
            r.is_random_next = None
            flat_a = _owned_array(lib, r.a_ids, r.n_a_ids,
                                  ctypes.c_int32, np.int32)
            r.a_ids = None
            flat_b = _owned_array(lib, r.b_ids, r.n_b_ids,
                                  ctypes.c_int32, np.int32)
            r.b_ids = None
            sel_pos = _owned_array(lib, r.mlm_pos, r.n_mlm,
                                   ctypes.c_int32, np.int32)
            r.mlm_pos = None
            label_ids = _owned_array(lib, r.mlm_labels, r.n_mlm,
                                     ctypes.c_int32, np.int32)
            r.mlm_labels = None
            sel_lens = _owned_array(lib, r.mlm_lens, n_inst,
                                    ctypes.c_int32, np.int32)
            r.mlm_lens = None
        finally:
            lib.lddl_masked_inst_free(res)  # see tokenize_docs: leak-free
        return (a_lens, seq_lens, rn, flat_a, flat_b, sel_pos, sel_lens,
                label_ids)


def segment_sums(values, counts):
    """Sums of consecutive runs of ``values``, run ``i`` being
    ``counts[i]`` long (int64)."""
    ends = np.cumsum(counts, dtype=np.int64)
    csum = np.zeros(len(values) + 1, dtype=np.int64)
    np.cumsum(values, out=csum[1:])
    return csum[ends] - csum[ends - counts]


def tokenize_sentences(tokenizer, sentences):
    """Token ids of sentences, without special tokens, as a vocab-file
    ``BertTokenizerFast`` gives them: ``(flat_ids, sentence_lens)``, int32.
    ``tokenizer`` is a ``NativeTokenizer``. The engine re-splits each
    sentence it is given; tokens never cross a sentence boundary (it
    falls on whitespace), so a sentence's ids are its pieces joined.
    The BART preprocess stores schema-v2 ids with it and the BART
    collate tokenizes schema-v1 chunk text with it, so the two agree by
    construction."""
    ids, piece_lens, piece_counts = tokenizer.tokenize_docs(sentences)
    return ids, segment_sums(piece_lens, piece_counts).astype(np.int32)


def bert_pairs(ids, sent_lens, doc_sent_counts, max_seq_length,
               short_seq_prob, duplicate_factor, seed, bucket, cls_id,
               sep_id, threads=None):
    """NSP pair creation over a tokenized bucket (lddl_tok_docs output),
    replaying the frozen CounterRNG streams of the Python engine
    (preprocess.bert.pairs_from_documents). Returns flat instance arrays
    (seq_ids, seq_lens, a_lens, is_random_next). ``threads=None`` resolves
    the pool width from LDDL_TPU_NATIVE_THREADS; output is byte-identical
    at every width (the pair streams are per-document-keyed)."""
    lib = _load()
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    sent_lens = np.ascontiguousarray(sent_lens, dtype=np.int32)
    doc_sent_counts = np.ascontiguousarray(doc_sent_counts, dtype=np.int32)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    res = lib.lddl_bert_pairs(
        ids.ctypes.data_as(p_i32), sent_lens.ctypes.data_as(p_i32),
        len(sent_lens), doc_sent_counts.ctypes.data_as(p_i32),
        len(doc_sent_counts), int(max_seq_length), float(short_seq_prob),
        int(duplicate_factor), int(seed) & (2**64 - 1),
        int(bucket) & (2**64 - 1), int(cls_id), int(sep_id),
        resolve_threads(threads))
    try:
        r = res.contents
        n = r.n_instances
        seq_ids = _owned_array(lib, r.seq_ids, r.n_seq_ids,
                               ctypes.c_int32, np.int32)
        r.seq_ids = None
        seq_lens_o = _owned_array(lib, r.seq_lens, n, ctypes.c_int32,
                                  np.int32)
        r.seq_lens = None
        a_lens = _owned_array(lib, r.a_lens, n, ctypes.c_int32, np.int32)
        r.a_lens = None
        rn = _owned_array(lib, r.is_random_next, n,
                          ctypes.c_uint8, np.uint8).view(np.bool_)
        r.is_random_next = None
    finally:
        lib.lddl_pairs_free(res)  # see tokenize_docs: leak-free
    return seq_ids, seq_lens_o, a_lens, rn


def mask_batch(key_bytes, ids, candidate, num_to_predict, mask_id,
               vocab_size, threads=None):
    """Static MLM masking — a bit-exact native replay of
    ops.masking.mask_batch_numpy on the numpy-Philox stream keyed by
    ``key_bytes`` (utils.rng.sample_key_bytes). Returns (masked_ids,
    selected), or None when the parameters fall outside the frozen
    replay contract (vocab size must be in [2, 2^32)) or
    ``LDDL_TPU_NATIVE_MASK=0`` turns C++ masking off (the caller masks
    with ``mask_batch_numpy`` then)."""
    lib = _load()
    if not mask_enabled():
        return None
    vocab_size = int(vocab_size)
    if not (2 <= vocab_size < 0xFFFFFFFF):
        return None
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    candidate = np.ascontiguousarray(candidate, dtype=np.uint8)
    num_to_predict = np.ascontiguousarray(num_to_predict, dtype=np.int64)
    n, width = ids.shape
    out = np.empty_like(ids)
    selected = np.empty((n, width), dtype=np.uint8)
    k0, k1 = np.frombuffer(key_bytes, dtype="<u8")
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.lddl_mask_batch(
        int(k0), int(k1),
        ids.ctypes.data_as(p_i32), candidate.ctypes.data_as(p_u8),
        num_to_predict.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, width, int(mask_id), vocab_size,
        out.ctypes.data_as(p_i32), selected.ctypes.data_as(p_u8),
        resolve_threads(threads))
    return out, selected.view(np.bool_)


def split_docs(texts, splitter_blob=None, threads=None):
    """Sentence-split documents natively -> list of sentence lists.

    Same boundaries as preprocess.sentences.split_sentences — or, with
    ``splitter_blob`` (SplitterParams.serialize()), as
    split_sentences_learned (enforced by tests). ``texts`` may be a
    readers.DocSpans view (zero-copy: the kernel scans the spool buffer in place) or any
    sequence of str/bytes.
    """
    lib = _load()
    if not len(texts):
        return []
    buf, starts, ends, n, _keep = _doc_ranges(texts)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    res = lib.lddl_split_docs_spans(
        buf, starts.ctypes.data_as(p_i64), ends.ctypes.data_as(p_i64),
        n, splitter_blob, len(splitter_blob or b""),
        resolve_threads(threads))
    try:
        r = res.contents
        starts_o = np.ctypeslib.as_array(r.starts, shape=(r.n_sents,)).copy()
        ends_o = np.ctypeslib.as_array(r.ends, shape=(r.n_sents,)).copy()
        counts = np.ctypeslib.as_array(
            r.doc_sent_counts, shape=(r.n_docs,)).copy()
    finally:
        lib.lddl_split_result_free(res)
    out = []
    k = 0
    # errors="replace" mirrors the Python path's document decode; sentence
    # ranges of valid UTF-8 round-trip identically either way.
    for d in range(n):
        sents = []
        for _ in range(int(counts[d])):
            sents.append(bytes(buf[starts_o[k]:ends_o[k]])
                         .decode("utf-8", errors="replace"))
            k += 1
        out.append(sents)
    return out
