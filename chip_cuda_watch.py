#!/usr/bin/env python3
"""Check the rule by which ``chip_smoke.py`` counts the processes of a
CLI that opened a CUDA context.

``python3 chip_cuda_watch.py`` first reports whether ``import torch``
maps CUDA's ``libcuda.so`` in a fresh process. Then it
writes an 8 MiB corpus from seed 0 (phase 8's generator, bert_large's
30522-token vocab) and runs the port's BART preprocess CLI on it, schema
v2 and then v1, ``RUNS`` times each, with 8 spawned workers. That CLI
imports torch and opens no CUDA context. Each run is polled every 2 ms.
A poll counts a child of the CLI in two ways:

- ``sightings``: any child whose ``/proc/<pid>/maps`` shows libcuda;
- ``counted``: what ``chip_smoke.DeviceWatch`` counts, i.e. a sighting
  not ruled out by ``chip_smoke.not_yet_execed``, read before the maps.

One line per run shows both, with each sighted child's ``cmdline`` and
``exe`` and its parent's, read just after the maps. The script exits 1
if any run counts a process. It needs a card: the watch compares against
a process that has initialised CUDA, as ``chip_smoke.py``'s has.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import chip_smoke as cs

RUNS = 4
POLL_S = 0.002


def _image(pid):
    img = cs.process_image(pid)
    if img is None:
        return None
    exe, cmdline, ppid = img
    return {"exe": exe, "ppid": ppid,
            "cmdline": cmdline.replace(b"\0", b" ")[:120].decode(
                errors="replace")}


def watch(cmd, root_dir):
    """Run ``cmd`` polled every ``POLL_S``; returns its report."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root_dir] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=root_dir,
                            env=env)
    sighted, counted, procs = {}, set(), set()
    stop = threading.Event()

    def run():
        while not stop.wait(POLL_S):
            pids = cs.descendants(proc.pid) - {proc.pid}
            procs.update(pids)
            for pid in pids:
                pre_exec = cs.not_yet_execed(pid)
                if not cs.maps_library(pid, "libcuda.so"):
                    continue
                if not pre_exec:
                    counted.add(pid)
                if pid not in sighted:
                    me = _image(pid) or {}
                    parent = _image(me.get("ppid", 0)) or {}
                    sighted[pid] = {
                        "t": round(time.perf_counter() - t0, 4),
                        "pre_exec": pre_exec, "cmdline": me.get("cmdline"),
                        "exe": me.get("exe"),
                        "parent_cmdline": parent.get("cmdline"),
                        "parent_exe": parent.get("exe")}

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        stop.set()
        thread.join()
    if proc.returncode:
        raise SystemExit("{} failed ({}):\n{}".format(
            " ".join(cmd[:3]), proc.returncode, err[-3000:]))
    return {"seconds": round(time.perf_counter() - t0, 3),
            "procs": len(procs), "sightings": len(sighted),
            "counted": len(counted), "sighted": sighted}


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.cuda.mem_get_info()
    root_dir = os.path.dirname(os.path.abspath(__file__))
    for snippet in ("import torch", "import torch; torch.cuda.is_available()",
                    "import numpy, pyarrow"):
        out = subprocess.run(
            [sys.executable, "-c", snippet + "; print('libcuda.so' in "
             "open('/proc/self/maps').read())"],
            capture_output=True, text=True, check=True).stdout.strip()
        print("libcuda mapped after {!r}: {}".format(snippet, out),
              flush=True)
    from lddl_tpu_torch.testing import write_text_corpus, write_vocab
    tmp = tempfile.mkdtemp(prefix="chip_cuda_watch_")
    total = 0
    try:
        vocab = os.path.join(tmp, "vocab.txt")
        write_text_corpus(tmp, write_vocab(vocab, 30522, seed=0), 8 << 20,
                          num_files=16, seed=0)
        for i in range(RUNS):
            for schema in ("v2", "v1"):
                cmd = [sys.executable, "-m",
                       "lddl_tpu_torch.cli.preprocess_bart_pretrain",
                       "--wikipedia", tmp, "--sink",
                       os.path.join(tmp, "out{}{}".format(i, schema)),
                       "--target-seq-length", "880", "--num-blocks", "32",
                       "--sample-ratio", "0.9", "--seed", "12345",
                       "--local-workers", "8"]
                if schema == "v2":
                    cmd += ["--vocab-file", vocab]
                report = watch(cmd, root_dir)
                total += report["counted"]
                print(json.dumps(dict(run="bart {} #{}".format(schema, i),
                                      **report)), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(cs.card_line())
    if total:
        raise SystemExit("{} processes counted as holding a CUDA context"
                         .format(total))


if __name__ == "__main__":
    main()
