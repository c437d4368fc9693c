from node2vec_torch.walk.engine import WalkEngine, random_walks

__all__ = ["WalkEngine", "random_walks"]
