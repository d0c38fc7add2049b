from scdna_replication_tools_tpu_torch.parallel.distributed import (
    HostShard,
    init_distributed,
    process_rank_and_count,
)
from scdna_replication_tools_tpu_torch.parallel.mesh import (
    RankMesh,
    make_mesh,
    mesh_topology,
)

__all__ = ["HostShard", "init_distributed", "process_rank_and_count",
           "RankMesh", "make_mesh", "mesh_topology"]
