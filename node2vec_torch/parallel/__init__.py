"""Multi-process training and walks over a (data × model) mesh (port of
``node2vec_tpu/parallel``): one process a rank over ``torch.distributed``.

Ported: the mesh (``make_mesh``, ``initialize_distributed``), a local
launcher (``launch.spawn``), the walker-sharded walks on K1, K5 and K12, and
the column-sharded SGNS step and epoch (K13's pair lists, K16, K17, K3's
squares mode, K4), and the row-sharded SGNS and HS steps and epochs (K18
route_plan, K19 route_rows, K2's and K8's routed modes, K3, K4).  The
edge-partitioned walks raise ``NotImplementedError`` naming their ROADMAP
item.
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
from node2vec_torch.parallel.sharded_walk import (
    sharded_blocked_walk_chunk,
    sharded_dense_walk_chunk,
    sharded_walk_chunk,
)

_EP_NOT_PORTED = "the edge-partitioned walks are not ported yet (ROADMAP Queue A item 12)"


def edge_partitioned_walk(*args, **kwargs):
    raise NotImplementedError(_EP_NOT_PORTED)


def partition_packed_adjacency(*args, **kwargs):
    raise NotImplementedError(_EP_NOT_PORTED)


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
    "edge_partitioned_walk",
    "partition_packed_adjacency",
]
