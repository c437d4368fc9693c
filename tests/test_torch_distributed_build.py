"""node2vec_torch's distributed host-side graph build
(parallel/distributed_build.py) against node2vec_tpu's and against the
port's monolithic build, on the CPU.

Every stage runs per participant on a shard of the edge list; the results
must be bit-equal to the JAX package's ``run_local`` (names, local CSR,
reverse metadata, packed blocked shards) and to the port's
``build_graph`` + ``partition_blocked_graph(ranged_metadata=True)``, for
directed and undirected graphs, pre-indexed or integer or string names.
``run_distributed`` runs over two gloo ranks (``tests/torch_partition_ranks.py``,
no JAX), spawned while this process computes the references; its shards
equal ``run_local``'s, and the graph-sharded blocked walk on the assembled
shards equals the walk on the monolithic partition.
"""

import concurrent.futures
import pickle
import time

import numpy as np
import pytest
import torch

from node2vec_tpu import native as ref_native
from node2vec_tpu.parallel import distributed_build as ref_db
from node2vec_torch.graph import build_graph
from node2vec_torch.graph.indexer import index_edges
from node2vec_torch.parallel import distributed_build as db
from node2vec_torch.parallel import launch, make_mesh
from node2vec_torch.parallel.edge_partitioned_blocked import (
    load_partitioned_graph,
    partition_blocked_graph,
    save_partitioned_graph,
)

import torch_partition_ranks

KEYS = ("light", "biw", "bids", "brp", "indptr", "indices", "weights", "rev_enc", "pfx")
NPARTS, N_SHARDS = 4, 8


def _ref_native_loaded(deadline_s: float = 120.0) -> None:
    """Load the JAX package's native library, waiting out a concurrent build
    by another test worker (it compiles in place, and after one failed load
    gives up for the life of the process); fails if it never loads."""
    t_end = time.monotonic() + deadline_s
    while not ref_native.available():
        if time.monotonic() > t_end:
            pytest.fail(f"{ref_native._LIB_PATH} did not load within {deadline_s:.0f} s")
        time.sleep(0.5)


def _messy_edges(seed=0, n_edges=4000):
    """Sparse int64 names, duplicate edges with other weights, a hub that
    the trim cuts (the JAX package's tests/test_distributed_build.py)."""
    rng = np.random.default_rng(seed)
    names = np.unique(rng.integers(0, 10**12, 700).astype(np.int64))
    src = names[rng.integers(0, len(names), n_edges)]
    dst = names[rng.integers(0, len(names), n_edges)]
    src = np.concatenate([src, np.full(300, names[3])])
    dst = np.concatenate([dst, names[rng.integers(0, len(names), 300)]])
    keep = src != dst
    src, dst = src[keep], dst[keep]
    src = np.concatenate([src, src[:50]])
    dst = np.concatenate([dst, dst[:50]])
    return src, dst, rng.uniform(0.5, 2.0, len(src)).astype(np.float32)


def _to_str(a):
    return np.array([f"v{x:x}" if x % 3 else f"né·{x}" for x in a], dtype=object)


def _participants(mod, src, dst, w, nparts=NPARTS, **kw):
    kw = dict(dict(n_shards=N_SHARDS, max_out_degree=64, random_seed=7), **kw)
    return [mod.build_participant(p, nparts, torch_partition_ranks.shard(src, nparts, p),
                                  torch_partition_ranks.shard(dst, nparts, p),
                                  torch_partition_ranks.shard(w, nparts, p), **kw)
            for p in range(nparts)]


def _assert_results_equal(got, want, names=True):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g if isinstance(g, dict) else vars(g)
        w = w if isinstance(w, dict) else vars(w)
        for k in KEYS:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert (g["meta"], list(g["ranges"]), g["name_base"]) == (w["meta"], list(w["ranges"]),
                                                                 w["name_base"])
        if names and w["names"] is not None:
            np.testing.assert_array_equal(np.asarray(g["names"]).astype("U"),
                                          np.asarray(w["names"]).astype("U"))


def _assert_monolithic(results, src, dst, w, indexed, directed):
    g = build_graph((src, dst, w), indexed=indexed, directed=directed, max_out_degree=64,
                    random_seed=7)
    if not indexed:
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(r.names) for r in results]).astype("U"),
            np.asarray(g.names).astype("U"))
    np.testing.assert_array_equal(np.concatenate([r.indices for r in results]), g.indices)
    np.testing.assert_array_equal(np.concatenate([r.weights for r in results]), g.weights)
    base, parts = 0, []
    for r in results:
        parts.append(r.indptr[:-1] + base)
        base += r.indptr[-1]
    np.testing.assert_array_equal(np.concatenate(parts + [[base]])[: g.n_vertices + 1], g.indptr)
    pg = partition_blocked_graph(g.indptr, g.indices, g.weights, N_SHARDS, ranged_metadata=True)
    for i, k in enumerate(("light", "biw", "bids", "brp")):
        np.testing.assert_array_equal(np.concatenate([getattr(r, k) for r in results]),
                                      pg[i].numpy(), err_msg=k)
    return g


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``run_distributed`` at two gloo ranks (the spawn runs while this
    process builds the references): this module's edge lists with integer
    and string names, and the assembled shards' walk."""
    src, dst, w = _messy_edges(seed=1)
    edges = {"int": (src, dst, w), "str": (_to_str(src), _to_str(dst), w)}
    g = build_graph(edges["int"], indexed=False, directed=False, max_out_degree=48,
                    random_seed=5)
    walk = dict(starts=(np.arange(64, dtype=np.int32) * 7) % g.n_vertices, walk_length=6,
                p=0.5, q=2.0, seed=13)
    path = str(tmp_path_factory.mktemp("build") / "world2.pkl")
    with open(path, "wb") as f:
        pickle.dump({"epd": {}, "build": {"edges": edges, "walk": walk}}, f)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch.spawn, torch_partition_ranks.programs, 2, "gloo", "cpu", path,
                         timeout=300)
    kw = dict(n_shards=None, max_out_degree=48, random_seed=5, indexed=False, directed=False)
    local = {name: db.run_local(_participants(db, *e, nparts=2, **kw))
             for name, e in edges.items()}
    out = [r["build"] for r in future.result()]
    pool.shutdown()
    return dict(local=local, ranks=out)


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("indexed", [False, True])
def test_run_local_bit_equal_to_jax_and_monolithic(directed, indexed):
    """Four participants, eight shards: every participant's result equals
    the JAX package's ``run_local`` field by field, and the concatenated
    results equal the port's monolithic build and ranged partition."""
    _ref_native_loaded()  # JAX's participants trim with its native core
    src, dst, w = _messy_edges()
    if indexed:
        src, dst, _ = index_edges(src, dst)
        src, dst = src.astype(np.int64), dst.astype(np.int64)
    kw = dict(indexed=indexed, directed=directed)
    got = db.run_local(_participants(db, src, dst, w, **kw))
    _assert_results_equal(got, ref_db.run_local(_participants(ref_db, src, dst, w, **kw)))
    _assert_monolithic(got, src, dst, w, indexed, directed)
    assert [r.ranges for r in got] == [[2 * p, 2 * p + 1] for p in range(NPARTS)]


def test_string_names_bit_equal():
    """String names (multi-byte code points, shared prefixes) index to the
    host indexer's sorted-unique ids, equal to JAX's participants'."""
    _ref_native_loaded()
    src, dst, w = _messy_edges()
    src, dst = _to_str(src), _to_str(dst)
    kw = dict(indexed=False, directed=False)
    got = db.run_local(_participants(db, src, dst, w, **kw))
    _assert_results_equal(got, ref_db.run_local(_participants(ref_db, src, dst, w, **kw)))
    g = _assert_monolithic(got, src, dst, w, False, False)
    bases = [r.name_base for r in got]
    assert bases == sorted(bases) and got[0].meta["n_vertices"] == g.n_vertices


def test_string_names_refuse_indexed():
    gen = db.build_participant(0, 1, np.array(["a", "b"]), np.array(["b", "c"]), indexed=True)
    with pytest.raises(ValueError, match="integer vertex ids"):
        db.run_local([gen])


@pytest.mark.parametrize("names", ["int", "str"])
def test_run_distributed_equals_run_local(ranks, names):
    """Each gloo rank's ``run_distributed`` result equals participant
    ``rank`` of ``run_local`` on the same shards."""
    _assert_results_equal([r[names] for r in ranks["ranks"]], ranks["local"][names])


def test_assembled_shards_walk_bit_equal(ranks):
    """The graph-sharded blocked walk over the assembled shards (each rank
    holds its own range) equals the walk over the monolithic partition:
    paths, unfinished and fallback counts; every rank gathers the same."""
    for r in ranks["ranks"]:
        assembled, mono = r["walks"]
        np.testing.assert_array_equal(assembled[0], mono[0])
        assert assembled[1:] == mono[1:] == (0, 0)
        np.testing.assert_array_equal(assembled[0], ranks["ranks"][0]["walks"][0][0])
        assert (assembled[0][:, 0] >= 0).all()
    assert [r["assembled_shards"] for r in ranks["ranks"]] == [(0,), (1,)]


def test_assemble_partitioned_layout(tmp_path):
    """One participant's assembled graph holds its shards as
    ``load_partitioned_graph(shards=)`` reads them from the monolithic
    ranged save, on the asked device; with a mesh, a shard that is not the
    rank's data coordinate is refused."""
    src, dst, w = _messy_edges()
    results = db.run_local(_participants(db, src, dst, w, indexed=False, directed=False))
    g = build_graph((src, dst, w), indexed=False, directed=False, max_out_degree=64,
                    random_seed=7)
    save_partitioned_graph(str(tmp_path), g.indptr, g.indices, g.weights, N_SHARDS,
                           ranged_metadata=True)
    pg = db.assemble_partitioned(results[1], device="cpu")
    want = load_partitioned_graph(str(tmp_path), shards=(2, 3))
    assert pg.shards == want.shards == (2, 3)
    for k in ("light", "biw", "bids", "brp"):
        assert torch.equal(getattr(pg, k), getattr(want, k)), k
    assert pg[4:9] == want[4:9]
    with pytest.raises(ValueError, match="holds ranges"):
        db.assemble_partitioned(results[1], mesh=make_mesh(device="cpu"))


def test_run_distributed_world_of_one():
    """Without a mesh, ``run_distributed`` exchanges over ``build_mesh1d``
    (here a gloo world of one): one participant equals ``run_local``'s."""
    src, dst, w = _messy_edges(n_edges=1000)
    kw = dict(n_shards=2, indexed=False, directed=False, max_out_degree=64, random_seed=7)
    got = db.run_distributed(db.build_participant(0, 1, src, dst, w, **kw))
    _assert_results_equal([got], db.run_local([db.build_participant(0, 1, src, dst, w, **kw)]))
    assert got.ranges == [0, 1]
