"""BookCorpus downloader: books1.tar.gz -> one-book-per-line shards.

Counterpart of ``lddl_tpu/download/books.py`` (upstream LDDL:
lddl/download/books.py: download from the-eye.eu, untar,
round-robin book files into shards, book filename as the doc id).
"""

import argparse
import os
import tarfile

from ..utils.args import attach_bool_arg
from ..utils.fs import expand_outdir_and_mkdir, get_all_files_paths_under
from .utils import download, safe_extractall, shard_files_parallel

_URL = "https://the-eye.eu/public/AI/pile_preliminary_components/books1.tar.gz"


def untar(archive, outdir):
    with tarfile.open(archive, "r:gz") as tf:
        safe_extractall(tf, outdir)


def parse_book_file(path):
    """One book file -> one (doc_id, text); the doc id is the book's
    filename (whitespace replaced)."""
    with open(path, encoding="utf-8", errors="replace") as f:
        text = f.read()
    yield os.path.basename(path).replace(" ", "-"), text


def shard_books(books_dir, outdir, num_shards, num_processes=None):
    """Book files round-robin to shards, one pool worker per shard
    (ref: books.py:177-187)."""
    paths = [p for p in get_all_files_paths_under(books_dir)
             if p.endswith(".txt")]
    return shard_files_parallel(paths, outdir, num_shards, parse_book_file,
                                num_processes=num_processes)


def attach_args(parser=None):
    parser = parser or argparse.ArgumentParser(
        description="Download BookCorpus and make one-book-per-line shards")
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--num-shards", type=int, default=256)
    parser.add_argument("--local-archive", default=None,
                        help="pre-downloaded books1.tar.gz")
    parser.add_argument("--books-dir", default=None,
                        help="already-extracted books directory "
                             "(skips download+untar)")
    attach_bool_arg(parser, "download", default=True,
                    help_str="run the download step")
    parser.add_argument("--number-of-sharding-processes", type=int, default=0,
                        help="process-pool size for the sharding step "
                             "(0 = cpu count)")
    return parser


def main(args=None):
    args = args if args is not None else attach_args().parse_args()
    outdir = expand_outdir_and_mkdir(args.outdir)
    books_dir = args.books_dir
    if books_dir is None:
        archive = args.local_archive or os.path.join(outdir, "books1.tar.gz")
        if args.download and args.local_archive is None:
            download(_URL, archive)
        books_dir = os.path.join(outdir, "books1")
        untar(archive, outdir)
    n = shard_books(books_dir, outdir, args.num_shards,
                    num_processes=args.number_of_sharding_processes)
    print("books: {} books -> {} shards".format(n, args.num_shards))


if __name__ == "__main__":
    main()
