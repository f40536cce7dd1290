"""Data parallelism across processes (``mesh.py``); the other axes of the
JAX package's mesh are not ported."""

from .mesh import (DataParallel, Launch, MeshSpec, backend_and_device,  # noqa: F401
                   detect_launch, initialize_distributed, local_batch_size,
                   maybe_initialize_distributed, process_count, process_index,
                   process_shard, rank_rows)
