from node2vec_torch.graph.csr import DeviceGraph, Graph, build_csr, mirror_dedup, from_edge_arrays
from node2vec_torch.graph.indexer import index_edges
from node2vec_torch.graph.trim import trim_hotspot_edges
from node2vec_torch.graph.ingest import build_graph

__all__ = [
    "Graph",
    "DeviceGraph",
    "build_csr",
    "mirror_dedup",
    "from_edge_arrays",
    "index_edges",
    "trim_hotspot_edges",
    "build_graph",
]
