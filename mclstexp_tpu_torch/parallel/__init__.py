"""Multi-process paths of the port: process groups, meshes and sharding."""

from mclstexp_tpu_torch.parallel.mesh import make_mesh, shard_batch  # noqa: F401
