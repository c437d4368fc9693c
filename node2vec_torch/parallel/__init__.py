"""Multi-process training and walks over a (data × model) mesh (port of
``node2vec_tpu/parallel``): one process a rank over ``torch.distributed``.

Ported: the mesh (``make_mesh``, ``initialize_distributed``), a local
launcher (``launch.spawn``), the walker-sharded walks on K1, K5 and K12,
the column-sharded SGNS step and epoch (K13's pair lists, K16, K17, K3's
squares mode, K4), the row-sharded SGNS and HS steps and epochs (K18
route_plan, K19 route_rows, K2's and K8's routed modes, K3, K4), and the
graph-sharded blocked walks (``edge_partitioned_blocked``: K20 ep_bucket,
K21 ep_propose, K22 ep_member, K23 in K20's launch), the round-1 dense
graph-sharded walk (``edge_partitioned``: K24 epd_bucket, K25 epd_serve,
K26 epd_advance) and the distributed host-side graph build
(``distributed_build``, no device work).
"""

from node2vec_torch.parallel.mesh import Mesh, MeshConfig, initialize_distributed, make_mesh
from node2vec_torch.parallel.sharded_sgns import (
    ShardedSGNSState,
    col_sgns_epoch,
    init_sharded_state,
    sharded_sgns_step,
)
from node2vec_torch.parallel.rowsharded_hs import (
    RowHSState,
    hs_state_from_host,
    hs_state_to_host,
    init_hs_row_state,
    row_hs_epoch,
    row_hs_step,
    unshard_hs_rows,
)
from node2vec_torch.parallel.rowsharded_sgns import (
    RoutePlan,
    RowShardedState,
    init_row_state,
    plan_routes,
    row_sgns_epoch,
    row_sgns_step,
    row_state_from_host,
    row_state_to_host,
)
from node2vec_torch.parallel.edge_partitioned_blocked import (
    PartitionedBlockedGraph,
    edge_partitioned_blocked_walk,
    load_partitioned_graph,
    partition_blocked_graph,
    save_partitioned_graph,
)
from node2vec_torch.parallel.edge_partitioned import (
    edge_partitioned_walk,
    edge_partitioned_walk_plain,
    partition_packed_adjacency,
)
from node2vec_torch.parallel.sharded_walk import (
    sharded_blocked_walk_chunk,
    sharded_dense_walk_chunk,
    sharded_walk_chunk,
)

__all__ = [
    "make_mesh",
    "MeshConfig",
    "Mesh",
    "initialize_distributed",
    "sharded_walk_chunk",
    "sharded_dense_walk_chunk",
    "sharded_blocked_walk_chunk",
    "sharded_sgns_step",
    "col_sgns_epoch",
    "ShardedSGNSState",
    "init_sharded_state",
    "RowShardedState",
    "init_row_state",
    "row_sgns_epoch",
    "row_sgns_step",
    "row_state_to_host",
    "row_state_from_host",
    "RoutePlan",
    "plan_routes",
    "RowHSState",
    "init_hs_row_state",
    "row_hs_epoch",
    "row_hs_step",
    "hs_state_to_host",
    "hs_state_from_host",
    "unshard_hs_rows",
    "PartitionedBlockedGraph",
    "partition_blocked_graph",
    "save_partitioned_graph",
    "load_partitioned_graph",
    "edge_partitioned_blocked_walk",
    "edge_partitioned_walk",
    "edge_partitioned_walk_plain",
    "partition_packed_adjacency",
]
