"""BART pretraining preprocessor: sentence chunks of ~target_seq_length.

Counterpart of ``lddl_tpu/preprocess/bart.py``. Documents are
sentence-split, then sentences greedily accumulate (whitespace-token
counted) into chunks of at least ``target_seq_length - 3`` tokens; with
probability ``short_seq_prob`` a chunk targets a random shorter length.
Chunks are written as ``{sentences}`` parquet shards (schema v1) or, with
a tokenizer, with the ``sentence_ids``/``sentence_lens`` token-id columns
too (schema v2). No masking and no binning here: BART's noising (text
infilling, sentence permutation) is applied at load time
(``loader.bart``).

The schema-v2 ids come from ``TokenizerInfo.sentence_ids``: the port's
native WordPiece engine where the tokenizer's semantics are the native
engine's (a vocab table always), else the fast tokenizer's backend. The
BART loader's collate tokenizes schema-v1 chunk text with the same
function, so the stored ids are by construction what the v1 collate
derives; the reference's tokenizer gives the same ids.
"""

import dataclasses
import os

import numpy as np
import pyarrow as pa

from ..resilience.io import atomic_write, write_table_atomic
from ..utils import rng as lrng
from .binning import (DEFAULT_PARQUET_COMPRESSION, SINK_PROFILE_V2,
                      write_options_for_names)
from .runner import (processor_fingerprint, run_sharded_pipeline,
                     splitter_digest, train_splitter_params_from_corpus)
from .sentences import split_sentences, split_sentences_learned


@dataclasses.dataclass
class BartPretrainConfig:
    target_seq_length: int = 128
    short_seq_prob: float = 0.1
    # Sentence splitter: "rules" | "learned" (see BertPretrainConfig).
    splitter: str = "rules"

    def __post_init__(self):
        if self.target_seq_length < 8:
            raise ValueError("target_seq_length too small")
        if self.splitter not in ("rules", "learned"):
            raise ValueError("splitter must be rules|learned")


def chunks_from_sentences(sentences, config, g):
    """One document's sentences -> list of chunk strings (each sentence
    appended with a leading space). The draw sequence depends only on
    chunk completions, so any splitter engine producing the same
    sentences yields byte-identical chunks."""
    base_target = config.target_seq_length - 3
    chunks = []
    chunk = ""
    num_tokens = 0
    target = base_target
    if config.short_seq_prob > 0 and g.random() < config.short_seq_prob:
        target = int(g.integers(2, base_target + 1))
    for sentence in sentences:
        chunk += " " + sentence
        num_tokens += len(sentence.split())
        if num_tokens >= target:
            chunks.append(chunk)
            chunk = ""
            num_tokens = 0
            target = base_target
            if (config.short_seq_prob > 0
                    and g.random() < config.short_seq_prob):
                target = int(g.integers(2, base_target + 1))
    if num_tokens > 0:
        chunks.append(chunk)
    return chunks


def chunks_from_text(text, config, g, splitter_params=None):
    """One document -> list of chunk strings (Python splitter path)."""
    sentences = (split_sentences_learned(text, splitter_params)
                 if splitter_params is not None else split_sentences(text))
    return chunks_from_sentences(sentences, config, g)


class BartBucketProcessor:
    """Picklable per-bucket BART pipeline stage (see
    ``runner.BertBucketProcessor``). With a ``tokenizer`` (a vocab table,
    ``preprocess.get_tokenizer``) the parquet sink writes schema v2."""

    def __init__(self, config, seed, out_dir, output_format,
                 splitter_params=None, tokenizer=None):
        self.config = config
        self.seed = seed
        self.out_dir = out_dir
        self.output_format = output_format
        self.splitter_params = splitter_params
        self.tokenizer = tokenizer
        self._tok_info = None

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_tok_info"] = None  # rebuilt per process
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)

    @property
    def tok_info(self):
        if self._tok_info is None:
            from .bert import TokenizerInfo
            self._tok_info = TokenizerInfo(self.tokenizer)
        return self._tok_info

    def fingerprint(self):
        """Resume-manifest digest. The vocab enters only when a tokenizer
        makes the sink schema v2; the reference computes the same
        string, so a resumed run refuses drift identically."""
        parts = [type(self).__name__, self.config, self.seed,
                 self.output_format, splitter_digest(self.splitter_params)]
        if self.tokenizer is not None:
            parts.append("schema=" + self._schema_tag())
        parts.append("codec=" + DEFAULT_PARQUET_COMPRESSION)
        if self.tokenizer is not None and self.output_format == "parquet":
            # v2 BART shards use the tuned parquet layout.
            parts.append("v2sink=" + SINK_PROFILE_V2)
        return processor_fingerprint(*parts)

    def _schema_tag(self):
        return "v2:" + self.tok_info.vocab_digest

    def _id_columns(self, rows):
        """(sentence_ids, sentence_lens) ListArrays for the chunk strings,
        what ``loader.bart.BartCollate`` derives from the chunk text every
        epoch: the rules sentence split of the CHUNK (the collate never
        sees the learned splitter), then ``TokenizerInfo.sentence_ids``
        (the native WordPiece, or the fast tokenizer where the native
        engine's semantics differ)."""
        from ..native import segment_sums
        from .arrowcols import int32_list_array
        per_chunk = [split_sentences(r) for r in rows]
        flat = [s for sents in per_chunk for s in sents]
        flat_ids, sent_lens = self.tok_info.sentence_ids(flat)
        counts = np.fromiter(map(len, per_chunk), dtype=np.int64,
                             count=len(per_chunk))
        chunk_tokens = segment_sums(sent_lens, counts)
        return (int32_list_array(flat_ids, chunk_tokens),
                int32_list_array(sent_lens, counts))

    def _native_sentences(self, texts):
        """Whole-bucket native sentence split, or None for the Python
        splitter under ``LDDL_TPU_BART_NATIVE_SPLIT=0``. Zero-copy when
        ``texts`` is a ``readers.DocSpans`` spool view; the boundaries are
        the Python splitters', so chunk bytes do not depend on the
        engine."""
        if os.environ.get("LDDL_TPU_BART_NATIVE_SPLIT") == "0":
            return None
        from .. import native
        blob = (self.splitter_params.serialize()
                if self.splitter_params is not None else None)
        return native.split_docs(texts, splitter_blob=blob)

    def prepare(self, texts, bucket):
        """Compute phase of the two-phase sink protocol (see
        ``runner.BertBucketProcessor.prepare``): chunking and tokenization
        run here; the returned closure performs only the durable write."""
        g = lrng.sample_rng(self.seed, 0xBA27, bucket)
        lrng.shuffle(g, texts)
        rows = []
        per_doc_sentences = self._native_sentences(texts)
        if per_doc_sentences is not None:
            for sentences in per_doc_sentences:
                rows.extend(chunks_from_sentences(sentences, self.config, g))
        else:
            for text in texts:
                # The runner hands raw document bytes; chunking is str
                # based, so decode per document, after the shuffle.
                if isinstance(text, bytes):
                    text = text.decode("utf-8", errors="replace")
                rows.extend(chunks_from_text(
                    text, self.config, g,
                    splitter_params=self.splitter_params))
        out_dir = self.out_dir
        if self.output_format == "txt":
            path = os.path.join(out_dir, "{}.txt".format(bucket))

            def publish_txt():
                os.makedirs(out_dir, exist_ok=True)
                atomic_write(path, "".join(r + "\n" for r in rows))
                return {path: len(rows)}

            return publish_txt
        path = os.path.join(out_dir, "part.{}.parquet".format(bucket))
        fields = [("sentences", pa.string())]
        columns = {"sentences": rows}
        if self.tokenizer is not None:
            ids, lens = self._id_columns(rows)
            columns["sentence_ids"] = ids
            columns["sentence_lens"] = lens
            fields += [("sentence_ids", pa.list_(pa.int32())),
                       ("sentence_lens", pa.list_(pa.int32()))]
        write_options = write_options_for_names(columns)
        table = pa.table(columns, schema=pa.schema(fields))

        def publish():
            os.makedirs(out_dir, exist_ok=True)
            write_table_atomic(table, path,
                               compression=DEFAULT_PARQUET_COMPRESSION,
                               **write_options)
            return {path: len(rows)}

        return publish

    def __call__(self, texts, bucket):
        return self.prepare(texts, bucket)()


def run_bart_preprocess(
    corpus_paths,
    out_dir,
    config=None,
    num_blocks=64,
    sample_ratio=0.9,
    seed=12345,
    global_shuffle=True,
    output_format="parquet",
    comm=None,
    log=None,
    num_workers=1,
    spool_groups=None,
    resume=False,
    progress_interval=5.0,
    tokenizer=None,
    elastic=False,
    lease_ttl=30.0,
    holder_id=None,
    scatter_units=None,
):
    """Run the BART preprocess (the SPMD contract of
    ``run_sharded_pipeline``). Output: ``part.<k>.parquet`` with a
    ``sentences`` string column, plus the schema-v2 ``sentence_ids``/
    ``sentence_lens`` columns when a ``tokenizer`` (a vocab table) is
    given; the loader must then use the same vocab. ``num_workers`` > 1
    spawns a process pool: a script that calls this guards the call with
    ``if __name__ == "__main__":``."""
    config = config or BartPretrainConfig()
    if output_format not in ("parquet", "txt"):
        raise ValueError("output_format must be parquet|txt")
    splitter_params = (train_splitter_params_from_corpus(corpus_paths)
                       if config.splitter == "learned" else None)
    return run_sharded_pipeline(
        corpus_paths,
        out_dir,
        BartBucketProcessor(config, seed, out_dir, output_format,
                            splitter_params=splitter_params,
                            tokenizer=tokenizer),
        num_blocks=num_blocks,
        sample_ratio=sample_ratio,
        seed=seed,
        global_shuffle=global_shuffle,
        comm=comm,
        log=log,
        num_workers=num_workers,
        spool_groups=spool_groups,
        resume=resume,
        progress_interval=progress_interval,
        elastic=elastic,
        lease_ttl=lease_ttl,
        holder_id=holder_id,
        scatter_units=scatter_units,
    )
