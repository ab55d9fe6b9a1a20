"""Serving and training on a mesh over torch.distributed, one process a
rank (mesh.py says how): dp x tp serving (serve.py) and train steps
(training/), sequence-parallel mel generation (sp.py), and pipeline-
parallel T3 training (pipeline.py, a module of its own as in the JAX
package)."""
from .mesh import (Mesh, MeshAxes, P, PartitionSpec, flow_param_spec, make_mesh,
                   shard_params, shutdown, t3_param_spec)
from .serve import (make_dp_mesh, make_dp_tp_mesh, make_tp_mesh, replicate,
                    shard_generation_inputs, shard_t3_for_decode, shard_t3_for_serving)
from .sp import SeqComm, make_sp_mesh, sp_generate_mel
