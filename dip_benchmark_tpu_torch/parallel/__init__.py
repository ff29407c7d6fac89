"""Row sharding: the port of ``dip_benchmark_tpu/parallel``, single-controller
(one process, a mesh of ``torch.device``s, shards as tensors on them)."""

from .halo import (  # noqa: F401
    Mesh,
    exchange_row_halo,
    make_mesh,
    refresh_resident_cols,
    refresh_resident_halo,
    sharded_fused_pipeline,
    sharded_op,
)
