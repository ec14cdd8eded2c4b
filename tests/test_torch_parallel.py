"""The port's process group, communicator, mesh and rank rule
(lddl_tpu_torch.parallel, lddl_tpu_torch.loader.sharding, lddl_tpu_torch
.entry) against lddl_tpu's: the counterparts of tests/test_distributed.py,
the grouping rule of dp_info_of_process on synthetic device grids (equal
to the reference's on every layout, the overlap error included), and
multi-rank checks in spawned gloo worlds on the CPU (the communicator's
int64 collectives past 2^31, make_mesh's -1 rule and errors, the rank
rule and the batch placement on a real DeviceMesh, the 8-rank dryrun).
Everything here is exact: integers, shapes and placements."""

import os

import numpy as np
import pytest

import torch

from lddl_tpu_torch.parallel import (LocalCommunicator,
                                     ThreadGroupCommunicator, run_world)
from lddl_tpu_torch.parallel import testing as ptest


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_local_communicator():
    c = LocalCommunicator()
    assert c.rank == 0 and c.world_size == 1
    c.barrier()
    np.testing.assert_array_equal(c.allreduce_sum([1, 2]), [1, 2])


def test_thread_group_allreduce():
    def body(comm):
        local = np.arange(4) + comm.rank
        total = comm.allreduce_sum(local)
        mx = comm.allreduce_max([comm.rank])
        comm.barrier()
        return total, mx

    results = ThreadGroupCommunicator.spawn(4, body)
    expected_sum = np.arange(4) * 4 + sum(range(4))
    for total, mx in results:
        np.testing.assert_array_equal(total, expected_sum)
        assert mx[0] == 3


def test_thread_group_error_propagates():
    def body(comm):
        if comm.rank == 1:
            raise RuntimeError("boom")
        comm.barrier()

    with pytest.raises(RuntimeError, match="boom"):
        ThreadGroupCommunicator.spawn(3, body)


def test_get_communicator_and_node_info_without_a_group():
    from lddl_tpu_torch.parallel import get_communicator, node_info
    assert isinstance(get_communicator(), LocalCommunicator)
    assert node_info() == (0, 1)


class _Dev:

    def __init__(self, process_index):
        self.process_index = process_index


def _grid(shape, owner):
    grid = np.empty(shape, dtype=object)
    for coords in np.ndindex(*shape):
        grid[coords] = _Dev(owner(coords))
    return grid


# (shape, axis names, owner of the device at coords): one process per
# device, per dp block, per (dp, fsdp) block, with tp/sp peers split over
# processes, and a layout that maps one batch block to two groups.
LAYOUTS = {
    "one_per_device": ((2, 2, 2), ("dp", "tp", "sp"),
                       lambda c: c[0] * 4 + c[1] * 2 + c[2]),
    "one_per_dp_block": ((4, 2), ("dp", "tp"), lambda c: c[0]),
    "dp_fsdp_blocks": ((2, 2, 2), ("dp", "fsdp", "tp"),
                       lambda c: c[0] * 2 + c[1]),
    "model_axes_split": ((2, 2, 2), ("dp", "tp", "sp"),
                         lambda c: c[0] * 2 + c[2]),
    "no_data_axes": ((2, 4), ("tp", "sp"), lambda c: c[0]),
    "single_process": ((2, 2, 2), ("dp", "fsdp", "tp"), lambda c: 0),
    "overlap": ((2, 2), ("dp", "tp"), lambda c: 0 if c[1] == 0 else 1 + c[0]),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_dp_info_of_process_matches_reference(layout):
    from lddl_tpu.loader.sharding import dp_info_of_process as j_info
    from lddl_tpu_torch.loader.sharding import dp_info_of_process
    shape, names, owner = LAYOUTS[layout]
    grid = _grid(shape, owner)
    procs = sorted({d.process_index for d in grid.flat})
    for proc in procs:
        try:
            want = j_info(grid, names, proc)
        except ValueError as e:
            with pytest.raises(ValueError, match="multiple process"):
                dp_info_of_process(grid, names, proc)
            assert layout == "overlap", e
            continue
        assert layout != "overlap"
        assert dp_info_of_process(grid, names, proc) == want


def test_init_distributed_refuses_cpu_fallback(monkeypatch):
    from lddl_tpu_torch.parallel import init_distributed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed(device="cuda")
    with pytest.raises(ValueError, match="together"):
        init_distributed(device="cpu", init_method="tcp://127.0.0.1:1")
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_make_mesh_needs_the_group():
    from lddl_tpu_torch.parallel import make_mesh
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh({"dp": 1})


class _World(list):
    def __init__(self, results, store_ports):
        super().__init__(results)
        self.store_ports = store_ports


@pytest.fixture(scope="module")
def comm_world():
    """The world's results, and the port of the store the parent served
    its rendezvous on."""
    from lddl_tpu_torch.parallel import distributed
    ports = []
    make = distributed._world_store

    def recording(world_size):
        store = make(world_size)
        ports.append(store.port)
        return store

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(distributed, "_world_store", recording)
        out = run_world(2, ptest.communicator_world, device="cpu")
    return _World(out, ports)


def test_torch_communicator_int64_beyond_2_31(comm_world):
    for rank, out in enumerate(comm_world):
        assert out["type"] == "TorchCommunicator" and out["is_torch"]
        assert (out["rank"], out["world"]) == (rank, 2)
        assert out["sum"].dtype == np.int64
        np.testing.assert_array_equal(
            out["sum"], [2 * 2**31 + 1, -2 * 2**40, 1])
        np.testing.assert_array_equal(out["max"], [2**31 + 1, -(2**40), 1])


def test_ranks_join_the_parents_store(comm_world):
    """No window in which the rendezvous port is free: every rank is a
    client of the store the parent holds (``TORCHELASTIC_USE_AGENT_STORE``),
    and no helper that picks a port and lets it go is left in the port."""
    assert len(comm_world.store_ports) == 1
    port = comm_world.store_ports[0]
    assert port > 0
    for out in comm_world:
        assert out["master_port"] == str(port)
        assert out["agent_store"] == "True"
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "lddl_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith((".py", ".sh")):
                with open(os.path.join(dirpath, name)) as f:
                    assert "_free_port" not in f.read(), name


def test_node_info_reads_the_launcher(comm_world):
    assert [out["node"] for out in comm_world] == [(0, 1), (0, 1)]


def test_torch_communicator_refuses_a_world_of_one():
    from lddl_tpu_torch.parallel import TorchCommunicator
    with pytest.raises(RuntimeError, match="LocalCommunicator"):
        TorchCommunicator()


@pytest.fixture(scope="module")
def mesh_world():
    return run_world(4, ptest.mesh_world, device="cpu")


def test_make_mesh_4_ranks(mesh_world):
    """The counterpart of test_make_mesh_8_devices on a world of 4."""
    for out in mesh_world:
        assert out["shape"] == {"dp": 2, "tp": 2}
        assert out["dp_size"] == 2 and out["data_axes"] == ("dp",)
        assert out["inferred"] == {"dp": 2, "tp": 2}
        assert out["fsdp_dp_size"] == 2
        assert out["ambient"] and out["ambient_after"] is None
        errors = out["errors"]
        assert errors["two_inferred"].startswith("ValueError: at most one")
        assert errors["indivisible"].startswith("ValueError: cannot infer")
        assert errors["too_many"].startswith("ValueError: mesh")
        assert out["pp_mesh"] == {"pp": 2, "dp": 2}


def test_process_dp_info_on_a_real_mesh(mesh_world):
    """Ranks are laid out rank-major: on {dp: 2, tp: 2} ranks 0-1 are dp
    block 0 and 2-3 block 1; tp peers share their dp_rank."""
    for rank, out in enumerate(mesh_world):
        assert out["coords"] == (rank // 2, rank % 2)
        assert out["dp_info"] == (rank // 2, 2)
        assert out["fsdp_dp_info"] == (rank // 2, 2)


def test_to_device_batch_shards_rows_over_data_axes(mesh_world):
    """Each rank keeps its own dp block's rows, a plain tensor on its
    device: the global batch of 6 rows is sharded over dp (ranks 0-1 hold
    block 0, 2-3 block 1) and replicated over tp."""
    for rank, out in enumerate(mesh_world):
        kind, device, rows = out["batch"]
        assert (kind, device) == ("Tensor", "cpu")
        np.testing.assert_array_equal(rows, np.full((3, 5), rank // 2))


def test_default_device_is_the_local_rank_card(mesh_world):
    for rank, out in enumerate(mesh_world):
        assert "device='cpu'" in out["no_card"]
        assert out["default_device"] == "cuda:{}".format(rank)


def test_mesh_axes_for_matches_reference():
    import __graft_entry__ as ref
    from lddl_tpu_torch.entry import _mesh_axes_for
    for n in (1, 2, 3, 4, 6, 8, 16):
        assert _mesh_axes_for(n) == ref._mesh_axes_for(n)


def test_dryrun_multichip_8_ranks():
    """One sharded BERT and BART step on {dp:1, fsdp:2, tp:2, sp:2}: ring
    attention, fsdp-sharded parameters and moments, finite losses."""
    from lddl_tpu_torch.entry import dryrun_multichip
    out = dryrun_multichip(8, device="cpu")
    assert out["mesh"] == {"dp": 1, "fsdp": 2, "tp": 2, "sp": 2}
    assert out["attention"] == "ring"
    for kind in ("bert", "bart"):
        assert np.isfinite(out["{}_loss".format(kind)])
        n_params, n_moments = out["{}_fsdp_sharded".format(kind)]
        assert 0 < n_params <= n_moments


def test_entry_forward_on_cpu(monkeypatch):
    from lddl_tpu_torch.entry import entry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    fn, args = entry(device="cpu")
    assert [tuple(a.shape) for a in args] == [(4, 128)] * 3
    mlm, nsp = fn(*args)
    assert mlm.shape == (4, 128, 30522) and nsp.shape == (4, 2)
    assert torch.isfinite(mlm).all() and torch.isfinite(nsp).all()
