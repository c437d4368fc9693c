"""node2vec in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

A port of the JAX package ``node2vec_tpu`` beside it, one slice at a time:
host graph build (numpy + the C++ core in ``native/``), biased walks on the
dense engine (kernel K1) or, for heavy-tailed graphs, the blocked engine
(K5), or the CSR rejection engine on request (K12), vertex counts of a
corpus on the card (K6), frequent-vertex subsampling (K7), skip-gram and
CBOW with negative sampling or hierarchical softmax and row-wise Adagrad
(K2–K4, K8–K10), or SGNS with pre-aggregated SGD (K11), trained in memory,
over a streamed virtual corpus or from host slabs, and driven by
``Node2Vec``; beside them the pair-based and fused-table SGNS steps (K13,
K14) and the batched alias draw (K15).  Over a (data × model) process mesh
(``node2vec_torch.parallel``) the walks shard their walkers and SGNS
shards the tables' columns (K16, K17).  Each kernel's wrapper
launches it for CUDA tensors and runs its plain PyTorch version for CPU
tensors.  Kernels are built with nvcc at first use
(``node2vec_torch._build``); importing the package builds nothing and needs
no GPU.
"""

__version__ = "0.1.0"

from node2vec_torch.api import Node2Vec, random_walk, trim_index
from node2vec_torch.constants import (
    GENSIM_PARAMS,
    MAX_OUT_DEGREES,
    NODE2VEC_PARAMS,
    WORD2VEC_PARAMS,
    Node2VecParams,
    Word2VecParams,
)
from node2vec_torch.embedding import Node2VecBase, Node2VecTorchEmbedding
from node2vec_torch.graph import Graph, build_graph, from_edge_arrays
from node2vec_torch.models.word2vec import Word2VecTorch
from node2vec_torch.walk import WalkEngine, random_walks

__all__ = [
    "Node2Vec",
    "trim_index",
    "random_walk",
    "Node2VecBase",
    "Node2VecTorchEmbedding",
    "Word2VecTorch",
    "WalkEngine",
    "random_walks",
    "__version__",
    "MAX_OUT_DEGREES",
    "NODE2VEC_PARAMS",
    "WORD2VEC_PARAMS",
    "GENSIM_PARAMS",
    "Node2VecParams",
    "Word2VecParams",
    "Graph",
    "build_graph",
    "from_edge_arrays",
]
