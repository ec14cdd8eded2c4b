"""Wikipedia downloader: dump -> wikiextractor -> one-article-per-line shards.

Counterpart of ``lddl_tpu/download/wikipedia.py`` (upstream LDDL:
lddl/download/wikipedia.py). Three skippable steps:
(1) download ``<lang>wiki-latest-pages-articles.xml.bz2``;
(2) extract article text with the external ``wikiextractor`` package;
(3) aggregate the extracted ``<doc ...>`` XML-ish files into
    ``source/<i>.txt`` shards, one article per line, id ``wiki-<id>``,
    title dropped (ref: wikipedia.py:48-85).

Each step gates its external dependency with a clear error and accepts
pre-staged inputs (``--local-dump``, ``--extracted-dir``) so offline
environments can run the later steps.
"""

import argparse
import os
import re
import subprocess
import sys

from ..utils.args import attach_bool_arg
from ..utils.fs import expand_outdir_and_mkdir, get_all_files_paths_under
from .utils import download, shard_files_parallel

_URLS = {
    "en": "https://dumps.wikimedia.org/enwiki/latest/enwiki-latest-pages-articles.xml.bz2",
    "zh": "https://dumps.wikimedia.org/zhwiki/latest/zhwiki-latest-pages-articles.xml.bz2",
}

_DOC_OPEN = re.compile(r'<doc id="([^"]+)"[^>]*>')


def parse_wikiextractor_file(path):
    """One wikiextractor output file -> (wiki-<id>, text) pairs. Articles
    open with ``<doc id=.. title=..>``, first content line repeats the
    title (dropped, ref wikipedia.py:60-66), and close with ``</doc>``."""
    with open(path, encoding="utf-8") as f:
        doc_id = None
        lines = []
        saw_title = False
        for raw in f:
            raw = raw.strip()
            m = _DOC_OPEN.match(raw)
            if m:
                doc_id = m.group(1)
                lines = []
                saw_title = False
                continue
            if raw == "</doc>":
                if doc_id is not None and lines:
                    yield "wiki-" + doc_id, " ".join(lines)
                doc_id = None
                continue
            if doc_id is None:
                continue
            if not saw_title:
                saw_title = True  # first line is the title: drop
                continue
            if raw:
                lines.append(raw)


def aggregate_extracted(extracted_dir, outdir, num_shards, prefix="",
                        num_processes=None):
    """wikiextractor output -> source shards, one pool worker per shard
    (ref: wikipedia.py:77-85)."""
    return shard_files_parallel(
        get_all_files_paths_under(extracted_dir), outdir, num_shards,
        parse_wikiextractor_file, num_processes=num_processes, prefix=prefix)


def run_wikiextractor(dump_path, extracted_dir):
    try:
        import wikiextractor  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "the 'wikiextractor' package is required for the extract step "
            "(pip install wikiextractor), or pass --extracted-dir with "
            "pre-extracted output") from e
    subprocess.run(
        [sys.executable, "-m", "wikiextractor.WikiExtractor", dump_path,
         "--output", extracted_dir],
        check=True)


def attach_args(parser=None):
    parser = parser or argparse.ArgumentParser(
        description="Download Wikipedia and make one-article-per-line shards")
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--langs", default="en",
                        help="comma-separated (en,zh)")
    parser.add_argument("--num-shards", type=int, default=256)
    parser.add_argument("--local-dump", default=None,
                        help="pre-downloaded .xml.bz2 (skips the download)")
    parser.add_argument("--extracted-dir", default=None,
                        help="pre-extracted wikiextractor output "
                             "(skips download+extract)")
    attach_bool_arg(parser, "download", default=True,
                    help_str="run the download step")
    attach_bool_arg(parser, "extract", default=True,
                    help_str="run the wikiextractor step")
    attach_bool_arg(parser, "shard", default=True,
                    help_str="run the sharding step")
    parser.add_argument("--number-of-sharding-processes", type=int, default=0,
                        help="process-pool size for the sharding step "
                             "(0 = cpu count)")
    return parser


def main(args=None):
    args = args if args is not None else attach_args().parse_args()
    outdir = expand_outdir_and_mkdir(args.outdir)
    for lang in args.langs.split(","):
        lang = lang.strip()
        if lang not in _URLS:
            raise ValueError("unsupported language {!r} (have {})".format(
                lang, sorted(_URLS)))
        dump_path = args.local_dump or os.path.join(
            outdir, "{}wiki-latest-pages-articles.xml.bz2".format(lang))
        if args.download and args.local_dump is None:
            download(_URLS[lang], dump_path)
        extracted = args.extracted_dir or os.path.join(outdir,
                                                       "extracted", lang)
        if args.extract and args.extracted_dir is None:
            run_wikiextractor(dump_path, extracted)
        if args.shard:
            # Per-language shard prefix: multiple --langs passes share one
            # outdir without overwriting each other.
            n = aggregate_extracted(
                extracted, outdir, args.num_shards, prefix=lang + "-",
                num_processes=args.number_of_sharding_processes)
            print("wikipedia[{}]: {} articles -> {} shards".format(
                lang, n, args.num_shards))


if __name__ == "__main__":
    main()
