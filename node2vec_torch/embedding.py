"""Embedding backend API (port of ``node2vec_tpu/embedding.py``).

``Node2VecBase`` is the reference's backend contract.
``Node2VecTorchEmbedding`` implements it on the PyTorch trainer: ``fit``,
``embedding``, ``get_vector``, the model file of ``save_model``/
``load_model`` (an npz of the tables, the vertex counts, the vocabulary
mask and the names) and the word2vec text format of ``save_vectors``/
``load_vectors`` (gensim ``KeyedVectors``-compatible).  Both files have the
JAX package's keys and dtypes, so either package loads the other's.
pandas is imported only by the functions that take or return a DataFrame.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np

from node2vec_torch.constants import Word2VecParams
from node2vec_torch.models.vocab import build_vocab_from_counts
from node2vec_torch.models.word2vec import Word2VecTorch


class Node2VecBase:
    """Abstract embedding-backend contract (reference embedding.py:22-66)."""

    def fit(self):
        raise NotImplementedError()

    def embedding(self):
        raise NotImplementedError()

    def get_vector(self, vertex_name: Union[str, int]):
        raise NotImplementedError()

    def save_model(self, cloud_path: str, model_name: str):
        raise NotImplementedError()

    def load_model(self, cloud_path: str, model_name: str):
        raise NotImplementedError()


def _as_name_id(name_id) -> Optional[Dict[int, Any]]:
    """Normalize a name<->id table into {id: name}."""
    if name_id is None:
        return None
    pd = sys.modules.get("pandas")
    if pd is not None and isinstance(name_id, pd.DataFrame):
        return dict(zip(name_id["id"].astype(int), name_id["name"]))
    if isinstance(name_id, np.ndarray):
        return dict(enumerate(name_id))
    return {int(k): v for k, v in name_id.items()}


class Node2VecTorchEmbedding(Node2VecBase):
    """SGNS embedding backend on the PyTorch trainer.

    Args:
      df_walks: walk corpus — int32 array [N, L+1] (-1 padded) or a DataFrame
        with a ``walk`` column of id lists.
      name_id: optional id->name mapping (DataFrame[name,id], array, or dict).
      w2v_params: Word2VecParams or reference-style dict.
      device: where the trainer runs ("cuda" by default).
    """

    MODEL_SUFFIX = ".npz"

    def __init__(
        self,
        df_walks=None,
        name_id=None,
        w2v_params: Optional[Union[Word2VecParams, Mapping[str, Any]]] = None,
        shared_negatives: int = 64,
        device="cuda",
    ):
        if isinstance(w2v_params, Word2VecParams):
            self.params = w2v_params
        else:
            self.params = Word2VecParams.from_dict(w2v_params)
        self.name_id = _as_name_id(name_id)
        self.walks = self._as_walks(df_walks)
        self.model = Word2VecTorch(self.params, shared_negatives=shared_negatives, device=device)
        self._name_to_id: Optional[Dict[Any, int]] = None

    @staticmethod
    def _as_walks(df_walks) -> Optional[np.ndarray]:
        if df_walks is None:
            return None
        pd = sys.modules.get("pandas")
        if pd is not None and isinstance(df_walks, pd.DataFrame):
            col = "walk" if "walk" in df_walks.columns else df_walks.columns[-1]
            seqs = [np.asarray(w, dtype=np.int64) for w in df_walks[col]]
            length = max(len(s) for s in seqs)
            out = np.full((len(seqs), length), -1, dtype=np.int32)
            for i, s in enumerate(seqs):
                out[i, : len(s)] = s
            return out
        return np.asarray(df_walks, dtype=np.int32)

    def fit(self, verbose: bool = False) -> Word2VecTorch:
        if self.walks is None:
            raise ValueError("No walks provided to fit()")
        self.model.fit(self.walks, verbose=verbose)
        return self.model

    def _check_fitted(self):
        if self.model.vocab is None or self.model._emb_in is None:
            raise RuntimeError("model not fitted; call fit() first")

    def embedding(self, as_frame: bool = True):
        """Per-vertex vectors with names mapped back via name_id when
        available: DataFrame[name, vector], or with ``as_frame=False`` the
        pair (names list, vectors [n, D] array) without importing pandas."""
        self._check_fitted()
        vocab_ids = np.nonzero(self.model.vocab.mask)[0]
        vectors = self.model.vectors[vocab_ids]
        if self.name_id is not None:
            names = [self.name_id[int(i)] for i in vocab_ids]
        else:
            names = vocab_ids.tolist()
        if not as_frame:
            return names, vectors
        import pandas as pd

        return pd.DataFrame({"name": names, "vector": list(vectors)})

    def get_vector(self, vertex_name: Union[str, int]) -> np.ndarray:
        self._check_fitted()
        if self.name_id is not None and not isinstance(vertex_name, (int, np.integer)):
            if self._name_to_id is None:
                self._name_to_id = {v: k for k, v in self.name_id.items()}
            if vertex_name not in self._name_to_id:
                raise KeyError(f"Unknown vertex name: {vertex_name!r}")
            vid = self._name_to_id[vertex_name]
        else:
            vid = int(vertex_name)
        return self.model.vector(vid)

    # -- persistence ------------------------------------------------------- #

    def save_model(self, cloud_path: str, model_name: str) -> None:
        """Both tables, the vertex counts, the vocabulary mask and the names
        as a compressed npz (the JAX package's keys and dtypes; ``names`` is
        empty without a name table)."""
        self._check_fitted()
        if not model_name.endswith(self.MODEL_SUFFIX):
            model_name += self.MODEL_SUFFIX
        os.makedirs(cloud_path, exist_ok=True)
        names = (
            np.array([self.name_id.get(i, i) for i in range(len(self.model.vectors))])
            if self.name_id is not None
            else np.array([])
        )
        np.savez_compressed(
            os.path.join(cloud_path, model_name),
            emb_in=self.model.emb_in,
            emb_out=self.model.emb_out,
            counts=self.model.vocab.counts,
            mask=self.model.vocab.mask,
            names=names,
        )

    def load_model(self, cloud_path: str, model_name: str) -> Word2VecTorch:
        """A model file of either package: the tables go to the model's
        device, and the vocabulary (mask and noise table) is rebuilt from
        the saved counts with this backend's min_count and ns_exponent."""
        if not model_name.endswith(self.MODEL_SUFFIX):
            model_name += self.MODEL_SUFFIX
        with np.load(os.path.join(cloud_path, model_name), allow_pickle=True) as z:
            self.model.emb_in = z["emb_in"]
            self.model.emb_out = z["emb_out"]
            self.model.vocab = build_vocab_from_counts(
                z["counts"],
                min_count=self.params.min_count,
                ns_exponent=self.params.ns_exponent,
            )
            if len(z["names"]):
                self.name_id = dict(enumerate(z["names"]))
                self._name_to_id = None
        return self.model

    def save_vectors(self, cloud_path: str, file_name: str) -> None:
        """word2vec text format (gensim KeyedVectors-compatible):
        header 'count dim', then 'name v1 v2 ...' per line."""
        self._check_fitted()
        os.makedirs(cloud_path, exist_ok=True)
        vocab_ids = np.nonzero(self.model.vocab.mask)[0]
        vectors = self.model.vectors
        dim = vectors.shape[1]
        with open(os.path.join(cloud_path, file_name), "w") as f:
            f.write(f"{len(vocab_ids)} {dim}\n")
            for vid in vocab_ids:
                name = self.name_id[int(vid)] if self.name_id is not None else vid
                vec = " ".join(f"{x:.6g}" for x in vectors[vid])
                f.write(f"{name} {vec}\n")

    def load_vectors(self, cloud_path: str, file_name: str):
        """A word2vec text file as DataFrame[name, vector]."""
        import pandas as pd

        names, vecs = [], []
        with open(os.path.join(cloud_path, file_name)) as f:
            header = f.readline().split()
            count, dim = int(header[0]), int(header[1])
            for line in f:
                parts = line.rstrip("\n").split(" ")
                names.append(parts[0])
                vecs.append(np.array(parts[1:], dtype=np.float32))
        if len(names) != count or (vecs and len(vecs[0]) != dim):
            raise ValueError("corrupt word2vec-format vector file")
        return pd.DataFrame({"name": names, "vector": vecs})
