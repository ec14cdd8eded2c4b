"""Shared downloader helpers.

Counterpart of ``lddl_tpu/download/utils.py`` (upstream LDDL:
lddl/download/utils.py:30-51). The output contract every downloader must
produce (consumed by lddl_tpu_torch.preprocess.readers):
``<outdir>/source/<i>.txt`` with ONE document per line whose first
whitespace token is the document id.
"""

import os
import sys
import urllib.request

from ..utils.cpus import usable_cpu_count


def safe_extractall(tf, outdir):
    """tarfile.extractall with the 'data' safety filter where available
    (the filter kwarg only exists from Python 3.10.12 / 3.11.4 / 3.12).
    On older interpreters, members are validated by hand first — the
    fallback must not reintroduce tar path traversal."""
    try:
        tf.extractall(outdir, filter="data")
        return
    except TypeError:
        pass
    base = os.path.realpath(outdir)
    for m in tf.getmembers():
        target = os.path.realpath(os.path.join(base, m.name))
        if target != base and not target.startswith(base + os.sep):
            raise ValueError("unsafe tar member path: {}".format(m.name))
        if m.issym():
            # Symlink targets resolve relative to the member's directory.
            link = os.path.realpath(
                os.path.join(os.path.dirname(target), m.linkname))
            if link != base and not link.startswith(base + os.sep):
                raise ValueError(
                    "unsafe tar link target: {} -> {}".format(
                        m.name, m.linkname))
        elif m.islnk():
            # Hardlink targets resolve relative to the archive root, like
            # the 'data' filter does.
            link = os.path.realpath(os.path.join(base, m.linkname))
            if link != base and not link.startswith(base + os.sep):
                raise ValueError(
                    "unsafe tar hardlink target: {} -> {}".format(
                        m.name, m.linkname))
        elif not (m.isfile() or m.isdir()):
            # FIFOs, device nodes, and any other special member types are
            # rejected, matching filter="data".
            raise ValueError(
                "special tar member type rejected: {}".format(m.name))
    tf.extractall(outdir)


def download(url, path, chunk_size=16 * 1024 * 1024, progress=True):
    """Streaming HTTP(S) download to ``path`` (stdlib only — training
    hosts often lack requests/tqdm; zero-egress environments get a clear
    error)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    try:
        with urllib.request.urlopen(url) as r, open(path, "wb") as f:
            total = r.headers.get("Content-Length")
            total = int(total) if total else None
            done = 0
            while True:
                chunk = r.read(chunk_size)
                if not chunk:
                    break
                f.write(chunk)
                done += len(chunk)
                if progress:
                    pct = " {:.1f}%".format(100 * done / total) if total else ""
                    sys.stderr.write("\r{} {:,} bytes{}".format(
                        os.path.basename(path), done, pct))
            if progress:
                sys.stderr.write("\n")
    except OSError as e:
        raise RuntimeError(
            "download of {} failed ({}); if this environment has no "
            "egress, fetch the archive elsewhere and pass it via the "
            "--local-* flag".format(url, e)) from e
    return path


def format_doc_line(doc_id, text):
    """One source line per document: ``<id> <flattened text>\\n``; None when
    the text is empty after newline flattening."""
    text = " ".join(text.split())
    if not text:
        return None
    if any(c.isspace() for c in doc_id):
        raise ValueError("doc id may not contain whitespace: "
                         "{!r}".format(doc_id))
    return doc_id + " " + text + "\n"


class _ShardWriter:
    """Writes documents round-robin into ``<outdir>/source/<i>.txt``."""

    def __init__(self, outdir, num_shards, prefix=""):
        # ``prefix`` namespaces shard files (e.g. per language) so multiple
        # passes into one outdir never truncate each other's shards.
        self._dir = os.path.join(outdir, "source")
        os.makedirs(self._dir, exist_ok=True)
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self._files = [
            open(os.path.join(self._dir, "{}{}.txt".format(prefix, i)), "w",
                 encoding="utf-8") for i in range(num_shards)
        ]
        self._count = 0

    def write(self, doc_id, text):
        line = format_doc_line(doc_id, text)
        if line is None:
            return
        f = self._files[self._count % len(self._files)]
        f.write(line)
        self._count += 1

    def close(self):
        for f in self._files:
            f.close()

    @property
    def num_documents(self):
        return self._count


def _write_shard_from_files(shard_path, input_paths, parse_fn):
    """Build ONE shard file from its assigned input files; returns the
    document count. Top-level so process pools can pickle it."""
    count = 0
    with open(shard_path, "w", encoding="utf-8") as f:
        for path in input_paths:
            for doc_id, text in parse_fn(path):
                line = format_doc_line(doc_id, text)
                if line is not None:
                    f.write(line)
                    count += 1
    return count


def shard_files_parallel(input_paths, outdir, num_shards, parse_fn,
                         num_processes=None, prefix=""):
    """Reference-style parallel sharding (ref lddl/download/wikipedia.py:
    77-85, books.py:177-187): input files are assigned round-robin to
    shards and a process pool builds each shard file independently —
    shard k = parse of ``input_paths[k::num_shards]``.

    ``parse_fn(path)`` must be a picklable top-level callable yielding
    (doc_id, text) pairs. Returns the total document count.
    """
    source_dir = os.path.join(outdir, "source")
    os.makedirs(source_dir, exist_ok=True)
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    input_paths = sorted(input_paths)
    if len(input_paths) < num_shards:
        # Same behavior as the reference (empty shards are written), but
        # say so: downstream block planning sees zero-byte inputs.
        sys.stderr.write(
            "warning: {} input files into {} shards leaves {} shard "
            "file(s) empty; consider --num-shards <= input file count\n"
            .format(len(input_paths), num_shards,
                    num_shards - len(input_paths)))
    shards = [
        (os.path.join(source_dir, "{}{}.txt".format(prefix, k)),
         input_paths[k::num_shards])
        for k in range(num_shards)
    ]
    if num_processes is None or num_processes == 0:
        num_processes = usable_cpu_count()
    num_processes = min(num_processes, num_shards)
    if num_processes <= 1:
        return sum(_write_shard_from_files(p, fps, parse_fn)
                   for p, fps in shards)
    import concurrent.futures
    import multiprocessing
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=num_processes,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        return sum(pool.map(_write_shard_from_files,
                            *zip(*[(p, fps, parse_fn) for p, fps in shards])))


def shard_documents(docs, outdir, num_shards):
    """docs: iterable of (doc_id, text) -> source shards; returns count."""
    writer = _ShardWriter(outdir, num_shards)
    try:
        for doc_id, text in docs:
            writer.write(doc_id, text)
    finally:
        writer.close()
    return writer.num_documents
