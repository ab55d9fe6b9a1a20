"""Serving on a dp x tp mesh over torch.distributed, one process a rank
(mesh.py says how); sequence and pipeline parallelism and training on a
mesh are ROADMAP item 21b."""
from .mesh import (Mesh, MeshAxes, P, PartitionSpec, flow_param_spec, make_mesh,
                   shard_params, shutdown, t3_param_spec)
from .serve import (make_dp_mesh, make_dp_tp_mesh, make_tp_mesh, replicate,
                    shard_generation_inputs, shard_t3_for_decode, shard_t3_for_serving)
