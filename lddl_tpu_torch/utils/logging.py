"""Scoped dataset logging.

Counterpart of ``lddl_tpu/utils/logging.py`` (``DummyLogger``,
``DatasetLogger``). A DatasetLogger hands out real loggers only on the
process/worker responsible for a scope ('node' -> node-rank 0 and worker
0, 'rank' -> worker 0, 'worker' -> everyone), so multi-host multi-worker
runs do not multiply log lines; with ``log_dir`` it also writes one file
per scope.
"""

import logging
import os
import pathlib


class DummyLogger:
    """A logger that drops everything (a scope this process does not own)."""

    def debug(self, *args, **kwargs):
        pass

    def info(self, *args, **kwargs):
        pass

    def warning(self, *args, **kwargs):
        pass

    def error(self, *args, **kwargs):
        pass

    def critical(self, *args, **kwargs):
        pass

    def exception(self, *args, **kwargs):
        pass

    def log(self, *args, **kwargs):
        pass


class DatasetLogger:

    def __init__(self, log_dir=None, log_level=logging.INFO, rank=0,
                 local_rank=0, node_rank=None, worker_rank=0):
        if node_rank is None:
            # The host's rank as torchrun names it (``GROUP_RANK``); 0 for
            # a single-host run. Read from the environment, not from
            # torch.distributed, so loader workers import no torch.
            node_rank = int(os.environ.get("GROUP_RANK", 0))
        self._log_dir = log_dir
        self._log_level = log_level
        self._rank = rank
        self._local_rank = local_rank
        self._node_rank = node_rank
        self._worker_rank = worker_rank
        if log_dir is not None:
            pathlib.Path(log_dir).mkdir(parents=True, exist_ok=True)
        self._loggers = {}

    def __getstate__(self):
        # logging.Logger objects do not pickle (process-mode loader workers
        # receive the dataset, which carries this); they rebuild lazily.
        state = self.__dict__.copy()
        state["_loggers"] = {}
        return state

    @property
    def rank(self):
        return self._rank

    @property
    def worker_rank(self):
        return self._worker_rank

    def _build_logger(self, scope):
        name = "lddl_tpu_torch.{}.rank{}.worker{}".format(
            scope, self._rank, self._worker_rank)
        logger = logging.getLogger(name)
        logger.setLevel(self._log_level)
        logger.propagate = False
        fmt = logging.Formatter(
            "%(asctime)s - node:{} rank:{} worker:{} - %(levelname)s - "
            "%(message)s".format(self._node_rank, self._rank,
                                 self._worker_rank))
        if not logger.handlers:
            sh = logging.StreamHandler()
            sh.setFormatter(fmt)
            logger.addHandler(sh)
        if self._log_dir is not None:
            # The logger is process-wide by name: add this log_dir's file
            # even when an earlier DatasetLogger of the rank built it.
            path = os.path.abspath(os.path.join(
                self._log_dir, "{}-rank{}-worker{}.log".format(
                    scope, self._rank, self._worker_rank)))
            if not any(getattr(h, "baseFilename", None) == path
                       for h in logger.handlers):
                fh = logging.FileHandler(path)
                fh.setFormatter(fmt)
                logger.addHandler(fh)
        return logger

    def to(self, scope):
        """A real logger only on the process/worker owning ``scope``."""
        if scope == "node":
            responsible = (self._rank == 0 and self._local_rank == 0
                           and self._worker_rank == 0)
        elif scope == "rank":
            responsible = self._worker_rank == 0
        elif scope == "worker":
            responsible = True
        else:
            raise ValueError("unknown log scope {!r}".format(scope))
        if not responsible:
            return DummyLogger()
        if scope not in self._loggers:
            self._loggers[scope] = self._build_logger(scope)
        return self._loggers[scope]
