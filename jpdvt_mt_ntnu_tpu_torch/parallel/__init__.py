"""Processes on a mesh: start-up and data parallelism (``mesh.py``); tensor
parallelism, fully-sharded data parallelism and expert parallelism, the
layout of the train state on the mesh (``sharding.py``); the GPipe
pipeline (``pipeline.py``) and ring-attention sequence parallelism
(``sequence.py``): every axis of the JAX package's mesh."""

from .mesh import (DataParallel, Launch, MeshSpec, backend_and_device,  # noqa: F401
                   detect_launch, initialize_distributed, local_batch_size,
                   maybe_initialize_distributed, process_count, process_index,
                   process_shard, rank_rows)
from .sharding import Layout, Mesh, MeshRanks, make_layout  # noqa: F401
