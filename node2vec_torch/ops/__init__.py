from node2vec_torch.ops.alias import (
    alias_draw,
    alias_draw_single,
    alias_draw_single_wiki,
    build_alias_csr,
    generate_alias_tables,
    generate_edge_alias_tables,
)
from node2vec_torch.ops.hashrng import fmix32, hash_bits, hash_uniform
from node2vec_torch.ops.sampling import (
    contains_in_segments,
    prefix_sums,
    searchsorted_in_segments,
)

__all__ = [
    "generate_alias_tables",
    "generate_edge_alias_tables",
    "build_alias_csr",
    "alias_draw",
    "alias_draw_single",
    "alias_draw_single_wiki",
    "searchsorted_in_segments",
    "contains_in_segments",
    "fmix32",
    "hash_bits",
    "hash_uniform",
    "prefix_sums",
]
