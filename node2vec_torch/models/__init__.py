from node2vec_torch.models.vocab import Vocabulary, build_vocab, build_vocab_from_counts
from node2vec_torch.models.skipgram import init_embeddings, sgns_train_step
from node2vec_torch.models.word2vec import Word2VecTorch

__all__ = [
    "Vocabulary",
    "build_vocab",
    "build_vocab_from_counts",
    "init_embeddings",
    "sgns_train_step",
    "Word2VecTorch",
]
