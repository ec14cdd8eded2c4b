"""Common Crawl news downloader.

Counterpart of ``lddl_tpu/download/common_crawl.py``. Upstream LDDL's
lddl/download/common_crawl.py wraps
``news-please``'s commoncrawl crawler with language/date/host filters,
streams articles into per-(pid, tid) buffer files flushed every
``--articles-per-write``, and finally aggregates+shards with a process
pool. We keep the same architecture with the crawler gated behind the
optional ``news-please`` package, and support the same resumable
multi-node prefix naming so several hosts can download concurrently into
one directory and shard once at the end
(ref: common_crawl.py:114-122,336-344).

Flag parity with the reference CLI (common_crawl.py:100-260): article and
WARC date windows with custom formats, --valid-hosts, --strict-date,
--reuse-previously-downloaded-files, --continue-after-error,
--show-download-progress, --delete-warc-after-extraction,
--continue-process, --number-of-extraction-processes,
--number-of-sharding-processes, and the skippable --newsplease/--shard
steps.
"""

import argparse
import os
import threading
import time

from ..utils.args import attach_bool_arg
from ..utils.cpus import usable_cpu_count
from ..utils.fs import expand_outdir_and_mkdir, get_all_files_paths_under
from .utils import shard_files_parallel


class ArticleBuffer:
    """Thread-local article buffering with periodic flush, mirroring the
    reference's streaming callback design (common_crawl.py:310-381)."""

    def __init__(self, txt_dir, prefix, articles_per_write=1000):
        self._txt_dir = txt_dir
        self._prefix = prefix
        self._articles_per_write = articles_per_write
        self._local = threading.local()
        os.makedirs(txt_dir, exist_ok=True)

    def _state(self):
        if not hasattr(self._local, "articles"):
            self._local.articles = []
            self._local.warc_count = 0
        return self._local

    def add(self, doc_id, text):
        state = self._state()
        state.articles.append((doc_id, text))
        if len(state.articles) >= self._articles_per_write:
            self.flush()

    def flush(self):
        state = self._state()
        if not state.articles:
            return
        # Unique name per (prefix, pid, tid, counter, time) so many hosts /
        # threads never collide on a shared filesystem.
        name = "{}-{}-{}-{}-{}.txt".format(
            self._prefix, os.getpid(), threading.get_ident(),
            state.warc_count, time.time_ns())
        with open(os.path.join(self._txt_dir, name), "w",
                  encoding="utf-8") as f:
            for doc_id, text in state.articles:
                f.write(doc_id + " " + " ".join(text.split()) + "\n")
        state.articles = []
        state.warc_count += 1


def crawl(outdir, prefix, valid_hosts=(), start_date=None, end_date=None,
          warc_files_start_date=None, warc_files_end_date=None,
          strict_date=True, langs=("en",), articles_per_write=1000,
          reuse_previously_downloaded_files=True, continue_after_error=True,
          show_download_progress=False, delete_warc_after_extraction=True,
          continue_process=True, number_of_extraction_processes=1):
    """Stream Common Crawl news articles into buffer files under
    ``<outdir>/txt`` (ref: common_crawl.py:454-483 for the kwargs)."""
    try:
        from newsplease.crawler import commoncrawl_crawler
    except ImportError as e:
        raise RuntimeError(
            "the 'news-please' package is required to crawl Common Crawl "
            "(pip install news-please); alternatively aggregate "
            "pre-downloaded article files with --txt-dir") from e
    buffer = ArticleBuffer(os.path.join(outdir, "txt"), prefix,
                           articles_per_write)
    langs = set(langs)

    def on_article(article):
        if article.language is not None and article.language not in langs:
            return
        text = article.maintext or ""
        if not text.strip():
            return
        buffer.add("cc-" + (article.url or "unknown").replace(" ", ""), text)

    def on_warc(*_args, **_kw):
        buffer.flush()

    commoncrawl_crawler.crawl_from_commoncrawl(
        on_article,
        callback_on_warc_completed=on_warc,
        valid_hosts=list(valid_hosts),
        start_date=start_date,
        end_date=end_date,
        warc_files_start_date=warc_files_start_date,
        warc_files_end_date=warc_files_end_date,
        strict_date=strict_date,
        reuse_previously_downloaded_files=reuse_previously_downloaded_files,
        local_download_dir_warc=os.path.join(outdir, "warc"),
        continue_after_error=continue_after_error,
        show_download_progress=show_download_progress,
        number_of_extraction_processes=number_of_extraction_processes,
        delete_warc_after_extraction=delete_warc_after_extraction,
        continue_process=continue_process,
        fetch_images=False,
    )
    buffer.flush()


def parse_buffer_file(path):
    """One streamed buffer file (one doc per line already) ->
    (doc_id, text) pairs."""
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split(None, 1)
            if len(parts) == 2:
                yield parts[0], parts[1]


def aggregate_txt(txt_dir, outdir, num_shards, num_processes=None):
    """Merge the streamed buffer files into the standard source shards,
    one pool worker per shard (ref: common_crawl.py:406-427). Every file
    under ``txt_dir`` is aggregated regardless of extension — the
    --txt-dir workflow accepts externally-produced buffer files."""
    return shard_files_parallel(
        get_all_files_paths_under(txt_dir), outdir, num_shards,
        parse_buffer_file, num_processes=num_processes)


def attach_args(parser=None):
    parser = parser or argparse.ArgumentParser(
        description="Download Common Crawl news and make source shards")
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--prefix", default="cc",
                        help="unique per host for multi-node downloads")
    parser.add_argument("--num-shards", type=int, default=256)
    parser.add_argument("--valid-hosts", nargs="*", default=[],
                        help="keep only articles from these hosts "
                             "(default: any host)")
    parser.add_argument("--start-date", default=None,
                        help="keep only articles published after this date")
    parser.add_argument("--start-date-format", default="%Y-%m-%d")
    parser.add_argument("--end-date", default=None,
                        help="keep only articles published before this date")
    parser.add_argument("--end-date-format", default="%Y-%m-%d")
    parser.add_argument("--warc-files-start-date", default=None,
                        help="download only .warc files published after "
                             "this date (controls download volume)")
    parser.add_argument("--warc-files-start-date-format", default="%Y-%m-%d")
    parser.add_argument("--warc-files-end-date", default=None,
                        help="download only .warc files published before "
                             "this date")
    parser.add_argument("--warc-files-end-date-format", default="%Y-%m-%d")
    parser.add_argument("--langs", nargs="+", default=["en"],
                        help="keep only articles in these languages")
    parser.add_argument("--articles-per-write", type=int, default=1000)
    parser.add_argument("--number-of-extraction-processes", type=int,
                        default=usable_cpu_count(),
                        help="newsplease extraction process count")
    parser.add_argument("--number-of-sharding-processes", type=int,
                        default=0,
                        help="process-pool size for the sharding step "
                             "(0 = cpu count)")
    attach_bool_arg(parser, "strict-date", default=True,
                    help_str="discard articles whose published date could "
                             "not be detected when date-filtering")
    attach_bool_arg(parser, "reuse-previously-downloaded-files", default=True,
                    help_str="skip .warc files already on disk (no "
                             "completeness check)")
    attach_bool_arg(parser, "continue-after-error", default=True,
                    help_str="keep downloading when newsplease errors")
    attach_bool_arg(parser, "show-download-progress", default=False,
                    help_str="show .warc download progress")
    attach_bool_arg(parser, "delete-warc-after-extraction", default=True,
                    help_str="delete each .warc once extracted")
    attach_bool_arg(parser, "continue-process", default=True,
                    help_str="resume from fully-downloaded but not fully "
                             "extracted .warc files (filters must not have "
                             "changed)")
    attach_bool_arg(parser, "newsplease", default=True,
                    help_str="run the crawl step")
    attach_bool_arg(parser, "shard", default=True,
                    help_str="run the sharding step (multi-node: shard once "
                             "after all hosts finish crawling)")
    parser.add_argument("--txt-dir", default=None,
                        help="aggregate these buffer files instead of "
                             "<outdir>/txt (implies --no-newsplease)")
    return parser


def _parse_date(s, fmt):
    import datetime
    return None if s is None else datetime.datetime.strptime(s, fmt)


def main(args=None):
    args = args if args is not None else attach_args().parse_args()
    outdir = expand_outdir_and_mkdir(args.outdir)
    txt_dir = args.txt_dir
    if txt_dir is None:
        txt_dir = os.path.join(outdir, "txt")
        if args.newsplease:
            crawl(
                outdir, args.prefix,
                valid_hosts=args.valid_hosts,
                start_date=_parse_date(args.start_date,
                                       args.start_date_format),
                end_date=_parse_date(args.end_date, args.end_date_format),
                warc_files_start_date=_parse_date(
                    args.warc_files_start_date,
                    args.warc_files_start_date_format),
                warc_files_end_date=_parse_date(
                    args.warc_files_end_date,
                    args.warc_files_end_date_format),
                strict_date=args.strict_date,
                langs=args.langs,
                articles_per_write=args.articles_per_write,
                reuse_previously_downloaded_files=(
                    args.reuse_previously_downloaded_files),
                continue_after_error=args.continue_after_error,
                show_download_progress=args.show_download_progress,
                delete_warc_after_extraction=(
                    args.delete_warc_after_extraction),
                continue_process=args.continue_process,
                number_of_extraction_processes=(
                    args.number_of_extraction_processes),
            )
    if args.shard:
        n = aggregate_txt(txt_dir, outdir, args.num_shards,
                          num_processes=args.number_of_sharding_processes)
        print("common_crawl: {} articles -> {} shards".format(
            n, args.num_shards))


if __name__ == "__main__":
    main()
