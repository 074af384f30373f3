"""Core contribution: tensor-network DSE for tensorized layers.

Port of ``src/repro/core/__init__.py``: the same public API, tensor-network
builders, MAC-guided top-K path search, the systolic latency simulator
(FPGA + TPU parameterizations), Algorithm-1 global search and TT-SVD, all
copied (NumPy), and the torch path executor (``core_tensors``,
``execute_path``).
"""

from .tensor_network import (
    GemmShape,
    Node,
    TensorNetwork,
    dense_linear_network,
    factorize,
    tt_conv_network,
    tt_linear_network,
)
from .paths import CandidatePath, find_topk_paths, greedy_path, reconstruction_path
from .simulator import (
    ALL_DATAFLOWS,
    ALL_PARTITIONINGS,
    STRATEGY_SPACE,
    Dataflow,
    FPGA_VU9P,
    HardwareConfig,
    Partitioning,
    gemm_latency,
    layer_latency,
    simulate,
)
from .tpu_cost import TPU_V5E
from .cost_table import (
    BackwardChoice,
    CostTables,
    TrainCostTables,
    build_cost_table_vectorized,
    build_cost_tables,
    build_cost_tables_hw,
    build_train_cost_tables,
    build_train_cost_tables_hw,
)
from .backward import (
    BackwardProblem,
    LayerBackward,
    TrainCostWeights,
    backward_networks,
    grad_core_network,
    grad_input_network,
    layer_backward,
    memoised_layer_backwards,
    update_seconds,
)
from .dse import (
    DSEResult,
    HwCandidateResult,
    LayerChoice,
    apply_calibration,
    brute_force_search,
    build_cost_table,
    explore_model,
    global_search,
    pareto_front,
)
from .tt import TTMatrix, reconstruction_error, tt_rand, tt_svd
from .contraction import core_tensors, execute_path

__all__ = [
    "GemmShape", "Node", "TensorNetwork", "dense_linear_network", "factorize",
    "tt_conv_network", "tt_linear_network",
    "CandidatePath", "find_topk_paths", "greedy_path", "reconstruction_path",
    "ALL_DATAFLOWS", "ALL_PARTITIONINGS", "STRATEGY_SPACE", "Dataflow",
    "FPGA_VU9P", "HardwareConfig", "Partitioning", "gemm_latency",
    "layer_latency", "simulate", "TPU_V5E",
    "CostTables", "build_cost_table", "build_cost_table_vectorized",
    "build_cost_tables", "build_cost_tables_hw",
    "BackwardChoice", "TrainCostTables", "build_train_cost_tables",
    "build_train_cost_tables_hw",
    "BackwardProblem", "LayerBackward", "TrainCostWeights",
    "backward_networks", "grad_core_network", "grad_input_network",
    "layer_backward", "memoised_layer_backwards", "update_seconds",
    "DSEResult", "HwCandidateResult", "LayerChoice", "apply_calibration",
    "brute_force_search", "explore_model", "global_search", "pareto_front",
    "TTMatrix", "reconstruction_error", "tt_rand", "tt_svd",
    "core_tensors", "execute_path",
]
