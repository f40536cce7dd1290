"""Processes on a mesh: start-up and data parallelism (``mesh.py``), tensor
parallelism and fully-sharded data parallelism (``sharding.py``); the
pipeline, expert and sequence axes of the JAX package's mesh are not ported."""

from .mesh import (DataParallel, Launch, MeshSpec, backend_and_device,  # noqa: F401
                   detect_launch, initialize_distributed, local_batch_size,
                   maybe_initialize_distributed, process_count, process_index,
                   process_shard, rank_rows)
from .sharding import Layout, Mesh, MeshRanks, make_layout  # noqa: F401
