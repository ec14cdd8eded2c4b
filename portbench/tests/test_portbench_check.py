"""The output check on tiny cells on the CPU: a sound run is correct; a
run with the timed path broken underneath is not, for each fault a
one-chip training cell can have; and the control, the reference in fp8,
fails the limits the program passes."""

import time

import pytest
import torch

from portbench import control, harness
from portbench.data import FIRST_ID
from portbench.tests.tiny import TINY_LIMITS, tiny_cell

CELLS = ("bert_large.p2_binned", "bart_base.L1024")
SEED = 2**31 + 99


def _run(workload, seed=SEED):
    cell = tiny_cell(workload)
    result, compared = harness.run(cell, seed, 0.5, False,
                                   torch.device("cpu"), time.time())
    return result, compared


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result, compared = _run(workload)
    assert result["correct"], compared
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == set()      # the tiny cells list none
    cell = tiny_cell(workload)
    # the check steps cover every bin of the traffic
    assert {k for k, _ in result["notes"]["check_steps"]} >= \
        cell.family.check_shapes(cell.traffic)
    assert len(result["notes"]["check_steps"]) >= cell.traffic["check_steps"]


def _unchanged_state(monkeypatch, workload):
    from lddl_tpu_torch.models import train
    monkeypatch.setattr(train.ClippedAdamW, "step", lambda self: None)


def _half_batch(monkeypatch, workload):
    import lddl_tpu_torch.models as models
    from lddl_tpu_torch.models import train

    def halve(loss):
        def half(outputs, batch, *args, **kw):
            n = batch["labels"].shape[0] // 2
            outputs = (tuple(o[:n] for o in outputs)
                       if isinstance(outputs, tuple) else outputs[:n])
            return loss(outputs, {k: v[:n] for k, v in batch.items()},
                        *args, **kw)
        return half

    if workload.startswith("bert"):
        monkeypatch.setattr(train, "bert_batch_loss",
                            halve(train.bert_batch_loss))
    else:
        monkeypatch.setattr(models, "bart_batch_loss",
                            halve(models.bart_batch_loss))


def _token_altered(monkeypatch, workload):
    from lddl_tpu_torch.loader import bart, bert
    cls = bert.BertCollate if workload.startswith("bert") else \
        bart.BartCollate
    collate = cls.__call__

    def altered(self, *args, **kw):
        batch = collate(self, *args, **kw)
        ids = batch["input_ids"]
        ids[0, 1] = FIRST_ID + (ids[0, 1] == FIRST_ID)
        batch["labels"][0, 1] = FIRST_ID + (batch["labels"][0, 1] == FIRST_ID)
        return batch

    monkeypatch.setattr(cls, "__call__", altered)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _token_altered],
                         ids=["unchanged_state", "half_batch",
                              "token_altered"])
def test_fault_underneath_fails_the_check(monkeypatch, workload, fault):
    fault(monkeypatch, workload)
    result, compared = _run(workload)
    assert not result["correct"], compared


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_where_the_program_passes(workload):
    cell = tiny_cell(workload)
    rows = [control.seed_readings(cell, s, torch.device("cpu"), True)
            for s in (3, 2**32 + 1)]
    summary = control.summarize(rows)
    assert all(summary["program"][k] <= lim
               for k, lim in TINY_LIMITS.items())
    assert any(summary["control"][k] > TINY_LIMITS[k]
               for k in summary["control"])
    assert summary["token"]["data_mismatches"] > 0
    assert any(summary["half_batch"][k] > TINY_LIMITS[k]
               for k in summary["half_batch"])


@pytest.mark.card
def test_cell_runs_correct_on_the_card(card):
    import json
    import subprocess
    import sys
    for workload in CELLS:
        out = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload", workload,
             "--seed", str(SEED), "--seconds", "5", "--trace", "0"],
            cwd=harness.REPO, capture_output=True, text=True, timeout=1200,
            check=True)
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
