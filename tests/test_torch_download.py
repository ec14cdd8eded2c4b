"""The port's downloaders (lddl_tpu_torch.download) against lddl_tpu's.

One counterpart per test of ``tests/test_download.py``: every fixture is
built live, fed to both packages, and the two ``source/`` trees are
compared byte for byte. Added: each CLI's flag surface equals the
reference's ``attach_args``, the three optional-package gates give the
reference's ``RuntimeError`` text, ``safe_extractall`` refuses the same
members on its by-hand fallback (the ``TypeError`` branch forced), and
the four CLIs, run as ``python -m lddl_tpu_torch.download.<name>`` with
the local-input flags and a spawned sharding pool, write the trees the
reference's CLIs write. No test touches the network.
"""

import argparse
import importlib
import io
import lzma
import os
import subprocess
import sys
import tarfile

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("lddl_tpu", "lddl_tpu_torch")
SOURCES = ("wikipedia", "books", "openwebtext", "common_crawl")


def mod(pkg, name):
    return importlib.import_module("{}.download.{}".format(pkg, name))


def tree_bytes(outdir):
    """{relative path: bytes} of every file under ``<outdir>/source``."""
    src = os.path.join(outdir, "source")
    out = {}
    for dirpath, _, names in os.walk(src):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, src)] = f.read()
    return out


def read_all_docs(pkg, outdir):
    """(id, text) of every document, read by ``pkg``'s own preprocess
    readers (the consumer of the downloaders' contract)."""
    readers = importlib.import_module(pkg + ".preprocess.readers")
    files = readers.discover_source_files({"x": outdir})
    docs = []
    for b in readers.plan_blocks(files, len(files)):
        docs.extend((d.decode("utf-8"), t.decode("utf-8"))
                    for d, t in readers.read_documents(b))
    return docs


def run_both(tmp_path, fn):
    """``fn(pkg, outdir)`` for both packages; asserts the two source trees
    are byte-equal and non-empty and returns (port outdir, port result)."""
    res, trees = {}, {}
    for pkg in PKGS:
        out = str(tmp_path / ("out-" + pkg))
        res[pkg] = fn(pkg, out)
        trees[pkg] = tree_bytes(out)
    assert trees["lddl_tpu_torch"] == trees["lddl_tpu"]
    assert any(trees["lddl_tpu"].values())
    assert res["lddl_tpu_torch"] == res["lddl_tpu"]
    return str(tmp_path / "out-lddl_tpu_torch"), res["lddl_tpu_torch"]


# ------------------------------------------- counterparts of test_download


def test_shard_writer_contract(tmp_path):
    docs_in = [("id-{}".format(i), "text with\nnewlines {}".format(i))
               for i in range(10)]
    out, n = run_both(tmp_path, lambda pkg, o: mod(pkg, "utils")
                      .shard_documents(docs_in, o, 3))
    assert n == 10
    docs = read_all_docs("lddl_tpu_torch", out)
    assert {d for d, _ in docs} == {"id-{}".format(i) for i in range(10)}
    assert all("\n" not in t for _, t in docs)
    for pkg in PKGS:
        with pytest.raises(ValueError, match="whitespace"):
            mod(pkg, "utils").shard_documents(
                [("bad id", "text")], str(tmp_path / pkg / "y"), 1)


def _wiki_fixture(root):
    extracted = root / "extracted" / "AA"
    extracted.mkdir(parents=True)
    (extracted / "wiki_00").write_text(
        '<doc id="12" url="u" title="Python">\n'
        "Python\n"
        "\n"
        "Python is a language.\n"
        "It is widely used.\n"
        "</doc>\n"
        '<doc id="34" title="JAX">\n'
        "JAX\n"
        "JAX is a library.\n"
        "</doc>\n")
    return str(root / "extracted")


def test_wikipedia_aggregation(tmp_path):
    src = _wiki_fixture(tmp_path)
    out, n = run_both(tmp_path, lambda pkg, o: mod(pkg, "wikipedia")
                      .aggregate_extracted(src, o, 2))
    assert n == 2
    docs = dict(read_all_docs("lddl_tpu_torch", out))
    assert docs["wiki-12"] == "Python is a language. It is widely used."
    assert docs["wiki-34"] == "JAX is a library."  # title dropped


def test_books_sharding(tmp_path):
    books = tmp_path / "books"
    books.mkdir()
    (books / "Moby Dick.txt").write_text("Call me Ishmael.\nSome years ago.")
    (books / "notes.pdf").write_text("not a book")
    out, n = run_both(tmp_path, lambda pkg, o: mod(pkg, "books")
                      .shard_books(str(books), o, 1))
    assert n == 1
    docs = read_all_docs("lddl_tpu_torch", out)
    assert docs[0][0] == "Moby-Dick.txt"
    assert "Ishmael" in docs[0][1]


def test_openwebtext_sharding(tmp_path):
    pages = tmp_path / "pages" / "subset0"
    pages.mkdir(parents=True)
    (pages / "page-a.txt").write_text("Content of page a.")
    (pages / "page-b.txt").write_text("Content of page b.")
    out, n = run_both(tmp_path, lambda pkg, o: mod(pkg, "openwebtext")
                      .shard_pages(str(tmp_path / "pages"), o, 2))
    assert n == 2
    assert {d for d, _ in read_all_docs("lddl_tpu_torch", out)} == \
        {"page-a", "page-b"}


def test_common_crawl_buffer_and_aggregate(tmp_path):
    """Buffer file names carry the pid, thread id and time, so the two
    packages' buffers are compared by their lines; one pre-written
    buffer directory is then aggregated by both into byte-equal trees."""
    lines = {}
    for pkg in PKGS:
        txt_dir = str(tmp_path / pkg / "txt")
        buf = mod(pkg, "common_crawl").ArticleBuffer(
            txt_dir, "cc", articles_per_write=2)
        for i in range(5):
            buf.add("cc-article-{}".format(i), "Body\nnumber {}.".format(i))
        buf.flush()
        names = sorted(os.listdir(txt_dir),
                       key=lambda n: int(n.split("-")[3]))
        assert len(names) == 3  # 2+2+1
        assert all(n.startswith("cc-{}-".format(os.getpid()))
                   for n in names)
        lines[pkg] = [open(os.path.join(txt_dir, n)).read()
                      for n in names]
    assert lines["lddl_tpu_torch"] == lines["lddl_tpu"]
    txt_dir = str(tmp_path / "lddl_tpu" / "txt")
    out, n = run_both(tmp_path, lambda pkg, o: mod(pkg, "common_crawl")
                      .aggregate_txt(txt_dir, o, 2))
    assert n == 5
    assert {d for d, _ in read_all_docs("lddl_tpu_torch", out)} == \
        {"cc-article-{}".format(i) for i in range(5)}


def test_shard_files_parallel_pool_matches_sequential(tmp_path):
    """The spawned-pool sharding path writes the sequential path's bytes,
    in both packages, and the port's trees equal the reference's."""
    books = tmp_path / "books"
    books.mkdir()
    paths = []
    for i in range(11):
        p = books / "book-{}.txt".format(i)
        p.write_text("Text of book {}.\nSecond line.".format(i))
        paths.append(str(p))
    trees = {}
    for pkg in PKGS:
        utils, parse = mod(pkg, "utils"), mod(pkg, "books").parse_book_file
        for procs in (1, 3):
            out = str(tmp_path / "{}-{}".format(pkg, procs))
            assert utils.shard_files_parallel(
                paths, out, 3, parse, num_processes=procs) == 11
            trees[pkg, procs] = tree_bytes(out)
    assert len(trees[PKGS[1], 3]) == 3 and all(trees[PKGS[1], 3].values())
    assert all(t == trees["lddl_tpu", 1] for t in trees.values())


def _flags(pkg, name):
    """(option strings, dest, default, nargs, type, required, const) of
    every action a downloader CLI's ``attach_args`` registers."""
    parser = mod(pkg, name).attach_args(argparse.ArgumentParser())
    return [(tuple(a.option_strings), a.dest, a.default, a.nargs,
             getattr(a.type, "__name__", a.type), a.required, a.const)
            for a in parser._actions]


def test_common_crawl_cli_flag_parity():
    """The CC CLI exposes the reference's full flag surface and parses a
    full command line into the same namespace."""
    argv = [
        "--outdir", "/tmp/x",
        "--valid-hosts", "example.com", "news.org",
        "--start-date", "2020-01-01",
        "--end-date", "2020-06-01",
        "--warc-files-start-date", "2020-01-01",
        "--warc-files-end-date", "2020-02-01",
        "--langs", "en",
        "--no-strict-date",
        "--no-reuse-previously-downloaded-files",
        "--no-continue-after-error",
        "--show-download-progress",
        "--no-delete-warc-after-extraction",
        "--no-continue-process",
        "--number-of-extraction-processes", "4",
        "--number-of-sharding-processes", "2",
        "--no-newsplease",
    ]
    parsed = {pkg: vars(mod(pkg, "common_crawl").attach_args()
                        .parse_args(argv)) for pkg in PKGS}
    assert parsed["lddl_tpu_torch"] == parsed["lddl_tpu"]
    args = argparse.Namespace(**parsed["lddl_tpu_torch"])
    assert args.valid_hosts == ["example.com", "news.org"]
    assert not args.strict_date
    assert not args.reuse_previously_downloaded_files
    assert not args.continue_after_error
    assert args.show_download_progress
    assert not args.delete_warc_after_extraction
    assert not args.continue_process
    assert args.number_of_extraction_processes == 4
    assert args.number_of_sharding_processes == 2
    assert not args.newsplease and args.shard


def test_common_crawl_no_newsplease_aggregates_outdir_txt(tmp_path):
    """--no-newsplease skips the crawl but still shards <outdir>/txt."""
    def run(pkg, outdir):
        txt = os.path.join(outdir, "txt")
        os.makedirs(txt)
        with open(os.path.join(txt, "host-1-2-0-3.txt"), "w") as f:
            f.write("cc-a Body a.\ncc-b Body b.\n")
        cc = mod(pkg, "common_crawl")
        cc.main(cc.attach_args().parse_args(
            ["--outdir", outdir, "--num-shards", "2", "--no-newsplease",
             "--number-of-sharding-processes", "1"]))

    out, _ = run_both(tmp_path, run)
    assert {d for d, _ in read_all_docs("lddl_tpu_torch", out)} == \
        {"cc-a", "cc-b"}


# ------------------------------------------------------------ additions


@pytest.mark.parametrize("name", SOURCES)
def test_cli_flags_match_reference(name):
    """Same option strings, destinations, defaults, nargs, types and
    required-ness as the reference's ``attach_args``, in the same order."""
    port = _flags("lddl_tpu_torch", name)
    assert port == _flags("lddl_tpu", name)
    assert any("--number-of-sharding-processes" in a[0] for a in port)


def _gate_error(pkg, name, blocked, call, monkeypatch, tmp_path):
    for m in blocked:
        monkeypatch.setitem(sys.modules, m, None)  # import raises
    with pytest.raises(RuntimeError) as info:
        call(mod(pkg, name), str(tmp_path))
    assert isinstance(info.value.__cause__, ImportError)
    return str(info.value)


@pytest.mark.parametrize("name,blocked,call", [
    ("wikipedia", ("wikiextractor",),
     lambda m, d: m.run_wikiextractor(os.path.join(d, "dump.xml.bz2"),
                                      os.path.join(d, "extracted"))),
    ("openwebtext", ("gdown",), lambda m, d: m.fetch_from_drive(d)),
    ("common_crawl", ("newsplease", "newsplease.crawler"),
     lambda m, d: m.crawl(d, "cc")),
], ids=["wikiextractor", "gdown", "news-please"])
def test_optional_package_gates(name, blocked, call, monkeypatch, tmp_path):
    """Each external step without its optional package fails with the
    reference's RuntimeError text, naming the package and the local flag
    that skips the step."""
    texts = [_gate_error(pkg, name, blocked, call, monkeypatch, tmp_path)
             for pkg in PKGS]
    assert texts[0] == texts[1]
    assert "--" in texts[1]


def _member(name, kind, linkname=""):
    info = tarfile.TarInfo(name)
    info.type = kind
    info.linkname = linkname
    if kind == tarfile.REGTYPE:
        info.size = 3
    return info


# Each archive holds one safe file and one member the extraction must
# refuse; the expected fallback message is the reference's.
UNSAFE = {
    "path-traversal": ([_member("../evil.txt", tarfile.REGTYPE)],
                       "unsafe tar member path"),
    "symlink-escape": ([_member("link", tarfile.SYMTYPE, "../../etc")],
                       "unsafe tar link target"),
    "hardlink-escape": ([_member("hard", tarfile.LNKTYPE, "../outside")],
                        "unsafe tar hardlink target"),
    "fifo": ([_member("pipe", tarfile.FIFOTYPE)],
             "special tar member type rejected"),
}


def _archive(path, members):
    with tarfile.open(path, "w") as tf:
        ok = _member("ok.txt", tarfile.REGTYPE)
        tf.addfile(ok, io.BytesIO(b"abc"))
        for m in members:
            tf.addfile(m, io.BytesIO(b"abc") if m.isfile() else None)


class _NoFilterTarFile(tarfile.TarFile):
    """A TarFile whose extractall lacks the ``filter`` keyword, as on
    interpreters before 3.10.12 / 3.11.4 / 3.12."""

    def extractall(self, path=".", members=None, **kw):
        if "filter" in kw:
            raise TypeError("extractall() got an unexpected keyword "
                            "argument 'filter'")
        return super().extractall(path, members, filter="fully_trusted")


@pytest.mark.parametrize("case", sorted(UNSAFE))
def test_safe_extractall_refuses_unsafe_members(case, tmp_path):
    """Both paths of ``safe_extractall`` refuse the member in both
    packages: the ``filter="data"`` path (the card's Python 3.12) with
    tarfile's own error, the by-hand fallback with the reference's
    ValueError text; nothing escapes the output directory."""
    members, message = UNSAFE[case]
    arc = str(tmp_path / "a.tar")
    _archive(arc, members)
    for pkg in PKGS:
        extract = mod(pkg, "utils").safe_extractall
        with tarfile.open(arc) as tf:
            with pytest.raises(tarfile.TarError):
                extract(tf, str(tmp_path / pkg / "data" / "out"))
        with _NoFilterTarFile.open(arc) as tf:
            with pytest.raises(ValueError, match=message):
                extract(tf, str(tmp_path / pkg / "fallback" / "out"))
        # The fallback validates every member before extracting any.
        assert not os.path.exists(str(tmp_path / pkg / "fallback" / "out"))
    assert not os.path.exists(str(tmp_path / "evil.txt"))


def test_safe_extractall_fallback_extracts_safe_archives(tmp_path):
    arc = str(tmp_path / "a.tar")
    _archive(arc, [_member("d/inner.txt", tarfile.REGTYPE),
                   _member("d/rel", tarfile.SYMTYPE, "inner.txt")])
    for pkg in PKGS:
        out = tmp_path / pkg
        with _NoFilterTarFile.open(arc) as tf:
            mod(pkg, "utils").safe_extractall(tf, str(out))
        assert (out / "ok.txt").read_bytes() == b"abc"
        assert (out / "d" / "rel").read_bytes() == b"abc"


# ---------------------------------------------- the four CLIs, end to end


def _write_inputs(root):
    """Local inputs in each source's upstream form, two or more docs each:
    wikiextractor files, a books1 tar.gz, an openwebtext tar.xz of .xz
    page-file subsets, and Common Crawl buffer files."""
    wiki = root / "wiki" / "AA"
    wiki.mkdir(parents=True)
    for k in range(3):
        (wiki / "wiki_{:02d}".format(k)).write_text("".join(
            '<doc id="{0}{1}" url="u" title="T{1}">\nT{1}\n\nArticle {0} '
            'body {1}.\nMore text.\n</doc>\n'.format(k, i) for i in range(2)))
    books = root / "books1" / "epubtxt"
    books.mkdir(parents=True)
    for k in range(5):
        (books / "Book {}.txt".format(k)).write_text(
            "Chapter one.\nBook {} text.".format(k))
    with tarfile.open(str(root / "books1.tar.gz"), "w:gz") as tf:
        tf.add(str(root / "books1"), arcname="books1")
    owt = root / "owt" / "openwebtext"
    owt.mkdir(parents=True)
    for s in range(2):
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as sub:
            for i in range(3):
                data = "Page {} of subset {}.".format(i, s).encode()
                info = tarfile.TarInfo("{}-{}.txt".format(s, i))
                info.size = len(data)
                sub.addfile(info, io.BytesIO(data))
        with lzma.open(str(owt / "urlsf_subset{:02d}.xz".format(s)),
                       "wb") as f:
            f.write(buf.getvalue())
    with tarfile.open(str(root / "openwebtext.tar.xz"), "w:xz") as tf:
        tf.add(str(owt), arcname="openwebtext")
    txt = root / "cctxt"
    txt.mkdir()
    for k in range(3):
        (txt / "cc-1-2-{}-9.txt".format(k)).write_text("".join(
            "cc-u{}{} News body {} {}.\n".format(k, i, k, i)
            for i in range(2)))


def _cli_args(name, root, outdir):
    return {
        "wikipedia": ["--no-download", "--no-extract", "--extracted-dir",
                      str(root / "wiki")],
        "books": ["--local-archive", str(root / "books1.tar.gz")],
        "openwebtext": ["--local-archive",
                        str(root / "openwebtext.tar.xz")],
        "common_crawl": ["--no-newsplease", "--txt-dir",
                         str(root / "cctxt")],
    }[name] + ["--outdir", outdir, "--num-shards", "4"]


@pytest.mark.parametrize("name", SOURCES)
def test_cli_source_trees_match_reference(name, tmp_path):
    """``python -m lddl_tpu_torch.download.<name>`` with the local-input
    flags and a pool of 2 spawned sharding workers writes the source
    tree the reference's ``main`` writes with one process."""
    _write_inputs(tmp_path)
    ref_out = str(tmp_path / "ref")
    ref = mod("lddl_tpu", name)
    ref.main(ref.attach_args().parse_args(
        _cli_args(name, tmp_path, ref_out)
        + ["--number-of-sharding-processes", "1"]))
    port_out = str(tmp_path / "port")
    proc = subprocess.run(
        [sys.executable, "-m", "lddl_tpu_torch.download." + name]
        + _cli_args(name, tmp_path, port_out)
        + ["--number-of-sharding-processes", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    prefix = "en-" if name == "wikipedia" else ""
    port = tree_bytes(port_out)
    assert sorted(port) == ["{}{}.txt".format(prefix, k) for k in range(4)]
    assert port == tree_bytes(ref_out)
    n = len(read_all_docs("lddl_tpu_torch", port_out))
    assert n == {"wikipedia": 6, "books": 5, "openwebtext": 6,
                 "common_crawl": 6}[name]
    assert "-> 4 shards" in proc.stdout and " {} ".format(n) in proc.stdout
