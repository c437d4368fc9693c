from node2vec_torch.ops.alias import build_alias_csr
from node2vec_torch.ops.hashrng import fmix32, hash_bits, hash_uniform
from node2vec_torch.ops.sampling import prefix_sums

__all__ = ["build_alias_csr", "fmix32", "hash_bits", "hash_uniform", "prefix_sums"]
