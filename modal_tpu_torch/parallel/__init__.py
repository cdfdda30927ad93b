"""Training (port of modal_tpu/parallel/): the train step on one device or
over a named mesh (`train.py`), the mesh and its process group
(`mesh.py`), the placement table (`sharding.py`), one rank's collectives
and gradient rules (`spmd.py`), the switch MoE FFN with expert parallelism
(`moe.py`), GPipe pipelining (`pipeline.py`) and ring attention over the
sequence (`ring_attention.py`)."""

from .mesh import AXIS_ORDER, MeshConstraintError, build_mesh, init_process_group, spawn, validate_mesh_constraints
from .train import TrainConfig, TrainState, create_sharded_state, create_state, train_demo

__all__ = [
    "AXIS_ORDER", "MeshConstraintError", "TrainConfig", "TrainState", "build_mesh", "create_sharded_state",
    "create_state", "init_process_group", "spawn", "train_demo", "validate_mesh_constraints",
]
