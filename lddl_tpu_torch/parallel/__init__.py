from .distributed import (Communicator, LocalCommunicator,
                          ThreadGroupCommunicator, TorchCommunicator,
                          get_communicator, init_distributed, node_info,
                          run_world)
from .mesh import (AXIS_DP, AXIS_FSDP, AXIS_PP, AXIS_SP, AXIS_TP, DATA_AXES,
                   data_parallel_size, get_abstract_mesh, make_mesh,
                   set_mesh)
from .pipeline import (make_pipelined_encoder, reference_encoder,
                       stack_layer_params, unstack_layer_params)

__all__ = [
    "AXIS_DP",
    "AXIS_FSDP",
    "AXIS_PP",
    "AXIS_SP",
    "AXIS_TP",
    "Communicator",
    "DATA_AXES",
    "LocalCommunicator",
    "ThreadGroupCommunicator",
    "TorchCommunicator",
    "data_parallel_size",
    "get_abstract_mesh",
    "get_communicator",
    "init_distributed",
    "make_mesh",
    "make_pipelined_encoder",
    "node_info",
    "reference_encoder",
    "run_world",
    "set_mesh",
    "stack_layer_params",
    "unstack_layer_params",
]
