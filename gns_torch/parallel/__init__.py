"""The parallel layer over torch.distributed (port of gns_tpu/parallel):
meshes, data parallelism for the solvers and serving, DP x GP training,
the explicit edge partition, tensor and pipeline parallelism. One process
per device; see parallel/mesh.py."""

from gns_torch.parallel.mesh import make_mesh  # noqa: F401
from gns_torch.parallel.pipeline import make_pipelined_forward  # noqa: F401
from gns_torch.parallel.sharding import (  # noqa: F401
    batch_sharding,
    make_sharded_train_step,
    shard_batch,
)
from gns_torch.parallel.tensor_parallel import (  # noqa: F401
    make_tp_train_step,
    shard_params_tp,
    tp_init_train_state,
)
