"""Pluggable storage backend: POSIX filesystem vs a mock object store.

Counterpart of ``lddl_tpu/resilience/backend.py``.

- :class:`LocalBackend`, the default: plain POSIX files. The hot paths
  in ``io.py`` do not dispatch through it: under ``local`` they are
  inline POSIX code.
- :class:`MockObjectStore`: an object store in a directory, with its
  semantics: no rename (objects appear only through
  multipart-upload-then-commit), versioned objects (every commit is a new
  immutable generation; conditional ops compare generations, like an
  ETag) and fault sites for the ``LDDL_TPU_FAULTS`` injector
  (``cas-put``, ``range-read``, ``multipart-commit``, ``list``). The
  loader's shard cache keys on those generations, and its tests advance
  them here.

Mock store layout::

    <dir>/.obj.<name>/u<pid>-<seq>.p<k>   uploaded parts (staging)
    <dir>/.obj.<name>/g<00000042>.json    commit record of generation 42
                                          (exclusive create: one winner
                                          per generation)
    <dir>/<name>                          materialized read view of the
                                          newest committed generation

The commit record is the linearization point, hard-linked into place from
a fully written temp (``os.link`` fails on EEXIST), so exactly one writer
wins each generation: that exclusive create is the store's
compare-and-swap. The materialized view lets plain-file readers keep
reading; versioned reads resolve through the commit records.

Selection is the ``LDDL_TPU_STORAGE_BACKEND`` environment variable
(``local`` | ``mock``), so spawned workers inherit it. Counters:
``backend_ops_total{backend,op,outcome}`` and
``backend_cas_conflicts_total``. ``is_cas`` tells the lease protocol
which shape to take: conditional puts on the mock store, atomic rename
and read-back on POSIX.

Mock store knobs, read once when the instance is made (one per process):
``LDDL_TPU_MOCK_PART_BYTES`` (multipart part size, default 256 KiB) and
``LDDL_TPU_MOCK_LATENCY_MS`` (a sleep before every get, put, list and
delete, never head; default 0).
"""

import errno
import json
import os
import shutil
import threading
import time

from . import faults
from ..observability import inc as obs_inc
from ..observability import observe as obs_observe

ENV_VAR = "LDDL_TPU_STORAGE_BACKEND"
BACKENDS = ("local", "mock")

OBJ_PREFIX = ".obj."

class CASConflict(RuntimeError):
    """A commit lost its precondition: another writer committed that
    generation first. Not an OSError, so the transient-error retry never
    repeats it blindly."""


def count(backend, op, outcome):
    obs_inc("backend_ops_total", backend=backend, op=op, outcome=outcome)


def observe_latency(backend, op, seconds):
    obs_observe("backend_op_latency_seconds", seconds, backend=backend,
                op=op)


def _conflict(backend, path, op):
    count(backend, op, "conflict")
    obs_inc("backend_cas_conflicts_total")
    raise CASConflict("{} precondition lost at {} ({})".format(
        op, path, backend))


def active_name():
    """The selected backend's name (``local`` unless the env says so)."""
    return os.environ.get(ENV_VAR) or "local"


_instances = {}
_instances_lock = threading.RLock()


def get_backend():
    """The active backend instance (one per name per process)."""
    name = active_name()
    with _instances_lock:
        inst = _instances.get(name)
        if inst is None:
            if name == "local":
                inst = LocalBackend()
            elif name == "mock":
                inst = MockObjectStore()
            else:
                raise ValueError(
                    "unknown storage backend {!r} ({}); expected one of "
                    "{}".format(name, ENV_VAR, "/".join(BACKENDS)))
            _instances[name] = inst
    return inst


def set_backend(name):
    """Select the backend for this process and future child processes."""
    if name not in BACKENDS:
        raise ValueError("unknown storage backend {!r}; expected one of "
                         "{}".format(name, "/".join(BACKENDS)))
    os.environ[ENV_VAR] = name


class LocalBackend:
    """The POSIX filesystem. The hot paths of ``resilience/io`` read and
    write it inline; through the backend go ranged reads
    (``io.read_range``). ``is_cas`` is False: POSIX has no conditional
    put, so the lease protocol keeps its atomic-rename + read-back shape
    here, and ``put_if_match`` takes only the create case (generation
    None), the same exclusive create a lease acquire makes."""

    name = "local"
    is_cas = False

    def put_if_match(self, path, data, expected_gen):
        if expected_gen is not None:
            raise NotImplementedError(
                "LocalBackend has no conditional replace: POSIX offers no "
                "CAS; the lease protocol uses atomic rename + read-back "
                "and publish-time fencing here")
        if isinstance(data, str):
            data = data.encode("utf-8")
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            _conflict(self.name, path, "cas-put")
        try:
            os.write(fd, data)
            os.fsync(fd)
        finally:
            os.close(fd)
        count(self.name, "cas-put", "ok")
        return 1

    def get_versioned(self, path):
        """(bytes, version) of the file, or (None, None) when absent. A
        POSIX file has no generation; the (size, mtime_ns) stat pair
        stands in, as ``io.object_head`` reports it. The local lease
        protocol never chains a conditional put off it."""
        from . import io as rio
        try:
            st = os.stat(path)
            return rio.read_bytes(path), (st.st_size, st.st_mtime_ns)
        except FileNotFoundError:
            return None, None

    def delete(self, path):
        try:
            os.remove(path)
        except FileNotFoundError:
            pass
        count(self.name, "delete", "ok")

    def delete_if_match(self, path, expected_gen):
        """Plain unlink (POSIX has no versions to compare). The local
        lease release does its own verified unlink and never calls
        this."""
        self.delete(path)
        return True

    def get(self, path, start=None, length=None):
        from . import io as rio
        if start is None and length is None:
            return rio.read_bytes(path)
        # Ranged read: pread only the requested window.
        faults.fault_point("open", path)
        lo = start or 0
        fd = os.open(path, os.O_RDONLY)
        try:
            if length is None:
                os.lseek(fd, lo, os.SEEK_SET)
                chunks = []
                while True:
                    c = os.read(fd, 1 << 20)
                    if not c:
                        break
                    chunks.append(c)
                data = b"".join(chunks)
            else:
                data = os.pread(fd, length, lo)
                while len(data) < length:   # short preads are legal
                    more = os.pread(fd, length - len(data), lo + len(data))
                    if not more:
                        break
                    data += more
        finally:
            os.close(fd)
        if faults.fault_point("range-read", path) == "truncate":
            data = data[:max(0, len(data) // 2 - 1)]
        count(self.name, "range-read", "ok")
        return data


class MockObjectStore:
    """Object store over a directory (module docstring has the layout).
    Thread- and process-safe: all coordination state is the
    exclusive-create commit records on disk."""

    name = "mock"
    is_cas = True

    # Commit records (and parts) of the newest two generations are kept,
    # so a reader that resolved the older one finishes against intact
    # parts; older ones are collected.
    _KEEP_GENS = 2

    # Bytes a multipart-upload part holds, unless LDDL_TPU_MOCK_PART_BYTES
    # says otherwise.
    _PART_BYTES = 1 << 18

    def __init__(self):
        self._lock = threading.Lock()
        self._upload_seq = 0
        self._list_cache = {}
        # Both knobs are read once, here; an unparsable value gives the
        # default.
        try:
            part = int(os.environ.get("LDDL_TPU_MOCK_PART_BYTES",
                                      self._PART_BYTES))
        except ValueError:
            part = self._PART_BYTES
        self._part_bytes = max(1, part)
        # LDDL_TPU_MOCK_LATENCY_MS: a remote store's round trip on every
        # data op (get, put, list, delete), never on head, whose metadata
        # probe costs far less than a GET on a real store.
        try:
            self._latency_s = max(0.0, float(os.environ.get(
                "LDDL_TPU_MOCK_LATENCY_MS", 0)) / 1e3)
        except ValueError:
            self._latency_s = 0.0

    def _lat(self):
        if self._latency_s > 0.0:
            time.sleep(self._latency_s)

    @staticmethod
    def _obj_dir(path):
        d, b = os.path.split(os.path.abspath(path))
        return os.path.join(d, OBJ_PREFIX + b)

    @staticmethod
    def _gen_name(gen):
        return "g{:08d}.json".format(gen)

    @staticmethod
    def _gens(odir):
        try:
            names = sorted(os.listdir(odir))
        except (FileNotFoundError, NotADirectoryError):
            return []
        gens = []
        for n in names:
            if n.startswith("g") and n.endswith(".json"):
                try:
                    gens.append(int(n[1:-5]))
                except ValueError:
                    continue
        return gens

    @classmethod
    def _current_gen(cls, odir):
        return max(cls._gens(odir), default=None)

    @classmethod
    def _read_meta(cls, odir, gen):
        with open(os.path.join(odir, cls._gen_name(gen)), "rb") as f:
            return json.loads(f.read())

    def _next_upload_id(self):
        with self._lock:
            self._upload_seq += 1
            return "{}-{}".format(os.getpid(), self._upload_seq)

    def _chunks_of(self, data):
        for off in range(0, len(data), self._part_bytes):
            yield data[off:off + self._part_bytes]

    def _upload_parts(self, odir, chunks):
        """Phase 1 of multipart-upload-then-commit: parts that no commit
        record references are invisible to every reader."""
        os.makedirs(odir, exist_ok=True)
        uid = self._next_upload_id()
        parts, total = [], 0
        for k, chunk in enumerate(chunks):
            pname = "u{}.p{:04d}".format(uid, k)
            ppath = os.path.join(odir, pname)
            faults.fault_point("open", ppath)
            with open(ppath, "wb") as f:
                f.write(chunk)
                f.flush()
                os.fsync(f.fileno())
            parts.append(pname)
            total += len(chunk)
        return uid, parts, total

    def _commit(self, path, odir, uid, parts, size, expected_gen):
        """Phase 2: the exclusive create of the next generation's commit
        record; a lost race is a CAS conflict."""
        if faults.fault_point("multipart-commit", path) == "conflict":
            _conflict(self.name, path, "multipart-commit")
        cur = self._current_gen(odir)
        if cur != expected_gen:
            _conflict(self.name, path, "cas-put")
        target = 1 if cur is None else cur + 1
        meta = {"parts": parts, "size": size, "upload": uid}
        tmp = os.path.join(odir, "commit.{}.tmp".format(uid))
        with open(tmp, "wb") as f:
            f.write(json.dumps(meta, sort_keys=True).encode("utf-8"))
            f.flush()
            os.fsync(f.fileno())
        gpath = os.path.join(odir, self._gen_name(target))
        try:
            try:
                os.link(tmp, gpath)
            except FileExistsError:
                _conflict(self.name, path, "cas-put")
            except OSError:
                # No hard links on this mount: O_EXCL is the same
                # exclusive create.
                try:
                    fd = os.open(gpath, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                except FileExistsError:
                    _conflict(self.name, path, "cas-put")
                try:
                    with open(tmp, "rb") as f:
                        os.write(fd, f.read())
                    os.fsync(fd)
                finally:
                    os.close(fd)
        finally:
            try:
                os.unlink(tmp)
            except FileNotFoundError:
                pass
        self._gc(odir, target)
        self._materialize(path, odir, meta)
        return target

    def _gc(self, odir, newest):
        """Drop commit records and parts older than the kept window;
        every step tolerates files already gone."""
        gens = self._gens(odir)
        keep = set()
        for g in gens:
            if g > newest - self._KEEP_GENS:
                try:
                    keep.update(self._read_meta(odir, g)["parts"])
                except (OSError, ValueError, KeyError):
                    continue
        for g in gens:
            if g > newest - self._KEEP_GENS:
                continue
            try:
                meta = self._read_meta(odir, g)
            except (OSError, ValueError):
                meta = {"parts": ()}
            for pname in meta.get("parts", ()):
                if pname not in keep:
                    try:
                        os.unlink(os.path.join(odir, pname))
                    except OSError:
                        pass
            try:
                os.unlink(os.path.join(odir, self._gen_name(g)))
            except OSError:
                pass

    def _materialize(self, path, odir, meta):
        """Mirror the committed object at its plain path (internal mirror
        maintenance; the store's API has no rename)."""
        tmp = "{}.tmp.{}".format(path, self._next_upload_id())
        with open(tmp, "wb") as f:
            for pname in meta["parts"]:
                with open(os.path.join(odir, pname), "rb") as pf:
                    shutil.copyfileobj(pf, f)
            f.flush()
            os.fsync(f.fileno())
        faults.fault_point("replace", path)
        os.replace(tmp, path)
        from . import io as rio
        rio._fsync_dir(path)

    def _put_once(self, path, chunks, expected_gen):
        self._lat()
        if faults.fault_point("cas-put", path) == "conflict":
            _conflict(self.name, path, "cas-put")
        odir = self._obj_dir(path)
        uid, parts, size = self._upload_parts(odir, chunks)
        return self._commit(path, odir, uid, parts, size, expected_gen)

    def put_if_match(self, path, data, expected_gen):
        """Conditional put: commits only while the object's current
        generation equals ``expected_gen`` (None: it must not exist).
        Returns the new generation; raises :class:`CASConflict` when the
        precondition is lost."""
        if isinstance(data, str):
            data = data.encode("utf-8")
        gen = self._put_once(path, self._chunks_of(data), expected_gen)
        count(self.name, "cas-put", "ok")
        return gen

    def _put_retry_races(self, path, chunks_fn):
        """Last-writer-wins put: retries lost CAS races, a bounded
        number of times."""
        last = None
        for _ in range(32):
            cur = self._current_gen(self._obj_dir(path))
            try:
                return self._put_once(path, chunks_fn(), cur)
            except CASConflict as e:
                last = e
        raise OSError(errno.EIO, "mock put of {} lost 32 consecutive CAS "
                      "races".format(path)) from last

    def put_atomic(self, path, data):
        if isinstance(data, str):
            data = data.encode("utf-8")
        self._put_retry_races(path, lambda: self._chunks_of(data))
        count(self.name, "put", "ok")

    def put_file(self, src, path):
        """Multipart upload of a fully written local file."""

        def chunks():
            with open(src, "rb") as f:
                while True:
                    c = f.read(self._part_bytes)
                    if not c:
                        return
                    yield c

        self._put_retry_races(path, chunks)
        count(self.name, "put", "ok")

    def _read_committed(self, odir, gen, start=None, length=None):
        meta = self._read_meta(odir, gen)
        buf = []
        for pname in meta["parts"]:
            with open(os.path.join(odir, pname), "rb") as f:
                buf.append(f.read())
        data = b"".join(buf)
        if start is not None or length is not None:
            lo = start or 0
            data = data[lo:] if length is None else data[lo:lo + length]
        return data

    def get(self, path, start=None, length=None):
        """The newest committed generation (ranged with start/length);
        paths never written through the store read as plain files."""
        self._lat()
        faults.fault_point("open", path)
        odir = self._obj_dir(path)
        cur = self._current_gen(odir)
        if cur is None:
            if not os.path.isfile(path):
                raise FileNotFoundError(errno.ENOENT, "no such object", path)
            with open(path, "rb") as f:
                if start:
                    f.seek(start)
                data = f.read(-1 if length is None else length)
        else:
            data = self._read_committed(odir, cur, start, length)
        ranged = start is not None or length is not None
        op = "range-read" if ranged else "read"
        if faults.fault_point(op, path) == "truncate":
            data = data[:max(0, len(data) // 2 - 1)]
        count(self.name, "range-read" if ranged else "get", "ok")
        return data

    def get_versioned(self, path):
        """(bytes, generation) of the current committed object, or
        (None, None) when the path was never committed."""
        self._lat()
        faults.fault_point("open", path)
        odir = self._obj_dir(path)
        cur = self._current_gen(odir)
        if cur is None:
            return None, None
        data = self._read_committed(odir, cur)
        if faults.fault_point("read", path) == "truncate":
            data = data[:max(0, len(data) // 2 - 1)]
        count(self.name, "get", "ok")
        return data, cur

    def head(self, path):
        """(size_bytes, generation) from the commit record alone;
        never-committed plain files report a stat version."""
        odir = self._obj_dir(path)
        cur = self._current_gen(odir)
        if cur is None:
            try:
                st = os.stat(path)
            except FileNotFoundError:
                return None, None
            count(self.name, "head", "ok")
            return st.st_size, ("stat", st.st_size, st.st_mtime_ns)
        try:
            meta = self._read_meta(odir, cur)
        except (OSError, ValueError):
            return None, None
        count(self.name, "head", "ok")
        return int(meta.get("size", 0)), cur

    def delete(self, path):
        """Unconditional delete: the commit records (authoritative), then
        the materialized view."""
        self._lat()
        shutil.rmtree(self._obj_dir(path), ignore_errors=True)
        try:
            os.remove(path)
        except (FileNotFoundError, IsADirectoryError):
            pass
        count(self.name, "delete", "ok")

    def delete_if_match(self, path, expected_gen):
        """Conditional delete (the lease release): only while the current
        generation is ``expected_gen``. Check and delete are two steps: a
        writer landing between them loses its commit, which the lease
        protocol tolerates (its worst case drops a clock-skewed thief's
        lease, as on the local path)."""
        cur = self._current_gen(self._obj_dir(path))
        if cur != expected_gen:
            _conflict(self.name, path, "delete")
        self.delete(path)
        return True

    def list(self, dirpath):
        """Sorted object names (committed objects and plain files, hidden
        names and publish scratch excluded); the ``stale`` fault serves
        this process's previous listing."""
        self._lat()
        try:
            names = sorted(os.listdir(dirpath))
        except (FileNotFoundError, NotADirectoryError):
            return None
        out = set()
        for n in names:
            if n.startswith(OBJ_PREFIX):
                if self._current_gen(os.path.join(dirpath, n)) is not None:
                    out.add(n[len(OBJ_PREFIX):])
            elif not n.startswith(".") and ".tmp." not in n:
                out.add(n)
        result = sorted(out)
        if faults.fault_point("list", dirpath) == "stale":
            prev = self._list_cache.get(dirpath)
            if prev is not None:
                count(self.name, "list", "stale")
                return list(prev)
        self._list_cache[dirpath] = tuple(result)
        count(self.name, "list", "ok")
        return result
