"""Parallelism on ``torch.distributed`` (port of ``marie_tpu/parallel/``):
device meshes in a local and a world form (:mod:`.mesh`), the world's
initialisation (:mod:`.distributed`), the sharding rules (:mod:`.sharding`),
the dp x tp training step (:mod:`.train`), and the pipeline, expert and
sequence legs (:mod:`.pipeline`, :mod:`.moe`, :mod:`.sequence`);
:mod:`.dryrun` runs every leg over n devices."""

from marie_tpu_torch.parallel.mesh import Mesh, create_mesh, default_mesh
from marie_tpu_torch.parallel.sharding import infer_param_sharding, shard_batch
from marie_tpu_torch.parallel.train import make_train_step

__all__ = [
    "Mesh",
    "create_mesh",
    "default_mesh",
    "infer_param_sharding",
    "shard_batch",
    "make_train_step",
]
