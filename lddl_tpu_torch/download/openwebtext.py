"""OpenWebText downloader: Drive archive -> nested .xz subsets -> shards.

Counterpart of ``lddl_tpu/download/openwebtext.py`` (upstream LDDL:
lddl/download/openwebtext.py: gdown fetch, nested .xz
extraction, round-robin sharding with the page filename as the doc id).
The Google-Drive fetch needs the optional ``gdown`` package; offline
environments pass ``--local-archive`` or ``--extracted-dir``.
"""

import argparse
import lzma
import os
import tarfile

from ..utils.fs import expand_outdir_and_mkdir, get_all_files_paths_under
from .utils import safe_extractall, shard_files_parallel

_DRIVE_ID = "1EA5V0oetDCOke7afsktL_JDQ-ETtNOvx"


def fetch_from_drive(outdir):
    try:
        import gdown
    except ImportError as e:
        raise RuntimeError(
            "the 'gdown' package is required to fetch OpenWebText from "
            "Google Drive (pip install gdown), or pass --local-archive") from e
    path = os.path.join(outdir, "openwebtext.tar.xz")
    gdown.download(id=_DRIVE_ID, output=path)
    return path


def extract_archive(archive, outdir):
    """openwebtext.tar.xz contains openwebtext/*.xz subset archives, each a
    tar of per-page .txt files."""
    top = os.path.join(outdir, "openwebtext")
    with tarfile.open(archive, "r:*") as tf:
        safe_extractall(tf, outdir)
    extracted = os.path.join(outdir, "extracted")
    os.makedirs(extracted, exist_ok=True)
    for subset in sorted(os.listdir(top)):
        if not subset.endswith(".xz"):
            continue
        sub_path = os.path.join(top, subset)
        with lzma.open(sub_path) as xz:
            with tarfile.open(fileobj=xz, mode="r:") as tf:
                safe_extractall(
                    tf, os.path.join(extracted, subset[:-len(".xz")]))
    return extracted


def parse_page_file(path):
    """One page file -> one (doc_id, text); the doc id is the page
    filename without extension."""
    with open(path, encoding="utf-8", errors="replace") as f:
        text = f.read()
    yield os.path.basename(path)[:-len(".txt")], text


def shard_pages(extracted_dir, outdir, num_shards, num_processes=None):
    """Page files round-robin to shards, one pool worker per shard
    (ref: openwebtext.py:127-160)."""
    paths = [p for p in get_all_files_paths_under(extracted_dir)
             if p.endswith(".txt")]
    return shard_files_parallel(paths, outdir, num_shards, parse_page_file,
                                num_processes=num_processes)


def attach_args(parser=None):
    parser = parser or argparse.ArgumentParser(
        description="Download OpenWebText and make one-page-per-line shards")
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--num-shards", type=int, default=256)
    parser.add_argument("--local-archive", default=None)
    parser.add_argument("--extracted-dir", default=None)
    parser.add_argument("--number-of-sharding-processes", type=int, default=0,
                        help="process-pool size for the sharding step "
                             "(0 = cpu count)")
    return parser


def main(args=None):
    args = args if args is not None else attach_args().parse_args()
    outdir = expand_outdir_and_mkdir(args.outdir)
    extracted = args.extracted_dir
    if extracted is None:
        archive = args.local_archive or fetch_from_drive(outdir)
        extracted = extract_archive(archive, outdir)
    n = shard_pages(extracted, outdir, args.num_shards,
                    num_processes=args.number_of_sharding_processes)
    print("openwebtext: {} pages -> {} shards".format(n, args.num_shards))


if __name__ == "__main__":
    main()
