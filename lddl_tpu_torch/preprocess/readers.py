"""Input discovery and block planning for the preprocessors.

The port's own copy of ``lddl_tpu/preprocess/readers.py``. The input
corpus is planned into an explicit list of byte-range Blocks once,
identically on every host, and hosts/workers pick blocks by striding.

Input contract (downloader output): UTF-8 text files where each line is
one document and the first ASCII-whitespace-separated token is the
document id (ref: lddl/dask/readers.py:131-136). The id/text split and
the empty-document filter are ASCII-whitespace-based (bytes semantics):
a document id separated from its text by a Unicode-only space
(e.g. NBSP) is treated as having empty text and dropped — the bundled
downloaders always emit ASCII separators; normalize external corpora to
this contract.
"""

import dataclasses
import os

import numpy as np

from ..utils.fs import get_all_files_paths_under
from ..utils import rng as lrng


@dataclasses.dataclass(frozen=True)
class Block:
    """A whole-line-aligned byte range of one input text file."""
    block_id: int
    path: str
    start: int
    end: int  # exclusive


class DocSpans:
    """Zero-copy document view: one contiguous bytes buffer + per-document
    (start, end) byte ranges. This is how a bucket's documents travel from
    the spool reader into the native engine — the kernel reads the raw
    buffer in place, so no per-document Python object (and no re-encoding
    pass) ever exists on the hot path.

    List-like for Python consumers: ``len``, iteration and indexing
    yield each document's bytes (a copy, made only when actually
    consumed). ``take_`` permutes the view in place — the in-bucket
    shuffle reorders two int64 arrays instead of a list of objects
    (utils.rng.shuffle dispatches on it with the identical draw
    contract)."""

    __slots__ = ("buffer", "starts", "ends")

    def __init__(self, buffer, starts, ends):
        self.buffer = buffer
        self.starts = np.ascontiguousarray(starts, dtype=np.int64)
        self.ends = np.ascontiguousarray(ends, dtype=np.int64)

    @classmethod
    def from_texts(cls, texts):
        """Pack a sequence of bytes into one buffer (tests/adapters; the
        spool reader builds views directly over its merged read buffer)."""
        texts = [t if isinstance(t, bytes) else t.encode("utf-8")
                 for t in texts]
        lens = np.fromiter(map(len, texts), dtype=np.int64,
                           count=len(texts))
        ends = np.cumsum(lens)
        return cls(b"".join(texts), ends - lens, ends)

    def __len__(self):
        return len(self.starts)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        return bytes(self.buffer[self.starts[i]:self.ends[i]])

    def __iter__(self):
        buf = self.buffer
        for s, e in zip(self.starts, self.ends):
            yield bytes(buf[int(s):int(e)])

    def take_(self, perm):
        """Reorder documents in place by ``perm`` (offset-array permute)."""
        self.starts = self.starts[perm]
        self.ends = self.ends[perm]
        return self


def _find_text_files_under(root):
    return [
        p for p in get_all_files_paths_under(root)
        if os.path.basename(p).endswith(".txt")
    ]


def discover_source_files(corpus_paths):
    """Flatten {corpus_name: path} into a sorted list of input text files.

    Each corpus path may point either at the corpus root (containing
    ``source/``), directly at a directory of ``.txt`` shards, or be an
    explicit list/tuple of text-file paths (the streaming-ingestion
    service hands landing files over this way) — explicit lists are
    sorted, so file order never depends on how the caller built them.
    """
    files = []
    for _, path in sorted(corpus_paths.items()):
        if path is None:
            continue
        if isinstance(path, (list, tuple)):
            explicit = sorted(str(p) for p in path)
            missing = [p for p in explicit if not os.path.isfile(p)]
            if missing:
                raise ValueError(
                    "explicit source file(s) missing: {}".format(missing))
            files.extend(explicit)
            continue
        source = os.path.join(path, "source")
        root = source if os.path.isdir(source) else path
        found = _find_text_files_under(root)
        if not found:
            raise ValueError("no .txt source shards under {}".format(root))
        files.extend(found)
    if not files:
        raise ValueError("no input corpora given")
    return files


def plan_blocks(input_files, target_num_blocks):
    """Deterministically split files into ~equal byte-range blocks.

    The block boundaries are provisional byte offsets; readers snap them to
    line boundaries (a block owns every line that *starts* inside it), so
    planning needs only file sizes — identical on every host.
    """
    sizes = [os.path.getsize(p) for p in input_files]
    total = sum(sizes)
    if total == 0:
        raise ValueError("input corpus is empty")
    target_num_blocks = max(1, int(target_num_blocks))
    block_size = max(1, total // target_num_blocks)
    blocks = []
    for path, size in zip(input_files, sizes):
        if size == 0:
            continue
        n = max(1, round(size / block_size))
        for i in range(n):
            start = size * i // n
            end = size * (i + 1) // n
            blocks.append(Block(len(blocks), path, start, end))
    return blocks


def read_block_lines(block):
    """Yield the RAW BYTES of the lines that start inside ``block`` (whole
    lines, no trailing \\n).

    Boundary rule: a line belongs to the block containing its first byte.
    A block whose start is mid-line skips forward to the next line start.

    Bytes, not str, on purpose: document text flows corpus -> spool ->
    gather -> C++ engine without ever paying a UTF-8 decode + re-encode
    round-trip over the whole corpus (the engine decodes once, in C).
    Invalid UTF-8 is neutral: the native normalizer drops U+FFFD, as
    HF's clean_text does.
    """
    with open(block.path, "rb") as f:
        if block.start == 0:
            f.seek(0)
        else:
            f.seek(block.start - 1)
            # If the previous byte is not a newline, our start is mid-line:
            # that line belongs to the previous block.
            prev = f.read(1)
            if prev != b"\n":
                f.readline()
        while f.tell() < block.end:
            line = f.readline()
            if not line:
                break
            yield line[:-1] if line.endswith(b"\n") else line


def split_id_text(raw_line):
    """'<doc id> <text...>' -> (doc_id, text); bytes in, bytes out (or str
    in, str out — the split-on-whitespace contract is ASCII whitespace,
    per the downloader output format). (ref: readers.py:131-136)"""
    parts = raw_line.split(None, 1)
    if len(parts) == 0:
        return None, raw_line[:0]
    if len(parts) == 1:
        return parts[0], raw_line[:0]
    return parts[0], parts[1]


def read_documents(block, sample_ratio=1.0, base_seed=12345):
    """Yield (doc_id, text) BYTES pairs for non-empty documents of a
    block, keeping each with probability ``sample_ratio`` (seeded per
    block, ref: readers.py:60-71 random_sample)."""
    g = lrng.sample_rng(base_seed, block.block_id) if sample_ratio < 1.0 else None
    for line in read_block_lines(block):
        if not line.strip():
            continue
        if g is not None and g.random() >= sample_ratio:
            continue
        doc_id, text = split_id_text(line)
        if not text.strip():
            continue
        yield doc_id, text
