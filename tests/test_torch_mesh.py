"""node2vec_torch's mesh, sharded walks and ``Node2Vec(mesh=)`` against
node2vec_tpu's on the CPU.

The port's ranks run in spawned processes over gloo
(``node2vec_torch.parallel.launch.spawn``, world sizes 2 and 4), from
``tests/torch_mesh_ranks.py``, which imports no JAX; the JAX package runs
in this process on its 8 virtual CPU devices at the same mesh shapes.
Weights in {0.5, 1, 2} and p, q powers of two make every partial sum
exact, so each rank's rows of the dense, blocked (with and without the
shared lists) and CSR sharded walks are bit-equal to its data coordinate's
rows of JAX's ``sharded_*_walk_chunk``, and ``WalkEngine(mesh=)`` gives
every rank the single-device engine's corpus, over chunks that do not
split evenly over the data axis.  ``Node2Vec(mesh=)`` at 2 × 1 walks
bit-equal to JAX's and embeds the quality graph within 0.05 micro-F1 of
JAX's column trainer.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import node2vec_tpu
import node2vec_tpu.datasets
from node2vec_tpu.constants import Node2VecParams as RefN2V
from node2vec_tpu.constants import Word2VecParams as RefW2V
from node2vec_tpu.graph import from_edge_arrays as ref_from_edge_arrays
from node2vec_tpu.parallel import make_mesh as ref_make_mesh
from node2vec_tpu.parallel.edge_partitioned import edge_partitioned_walk as ref_epd_walk
from node2vec_tpu.parallel.edge_partitioned import partition_packed_adjacency as ref_partition
from node2vec_tpu.parallel.sharded_walk import (
    sharded_blocked_walk_chunk as ref_sharded_blocked,
    sharded_dense_walk_chunk as ref_sharded_dense,
    sharded_walk_chunk as ref_sharded_csr,
)
from node2vec_tpu.walk import WalkEngine as RefWalkEngine
from node2vec_tpu.walk import blocked as ref_blocked
from node2vec_tpu.walk.dense import build_padded_adjacency as ref_packed
from node2vec_torch.constants import Node2VecParams
from node2vec_torch.datasets import multilabel_f1, synthetic_multilabel
from node2vec_torch.graph import from_edge_arrays
from node2vec_torch.parallel import launch, make_mesh
from node2vec_torch.walk import WalkEngine
from node2vec_torch.walk.csr import search_iters

import torch_mesh_ranks

SHAPES = {2: [(2, 1)], 4: [(4, 1), (2, 2)]}
SEED, GID_BASE, P, Q, LENGTH = 0xC0FFEE, 7, 0.25, 4.0, 10
ENGINE = dict(num_walks=1, walk_length=LENGTH, return_param=P, inout_param=Q, walker_chunk=101)
N2V = {"num_walks": 4, "walk_length": 12, "return_param": 0.25, "inout_param": 4.0}
W2V = {"vector_size": 32, "max_iter": 2, "min_count": 1, "batch_walks": 64}
QUALITY_N2V = dict(num_walks=6, walk_length=20)
QUALITY_W2V = dict(min_count=1, max_iter=3, vector_size=32)
EPD = dict(starts=(np.arange(64) % 34).astype(np.int32), seed=11, walk_length=8, p=0.5, q=2.0)


def _epd_draws(n_data: int) -> list:
    """JAX's edge_partitioned_walk uniforms of each data shard, in superstep
    order (``fold_in`` with the shard, a ``split`` a superstep)."""
    out = []
    for s in range(n_data):
        key = jax.random.fold_in(jax.random.PRNGKey(EPD["seed"]), s)
        draws = []
        for _ in range(4 * EPD["walk_length"] + 4):
            key, k_u = jax.random.split(key)
            draws.append(np.array(jax.random.uniform(k_u, (len(EPD["starts"]) // n_data,))))
        out.append(draws)
    return out


def _graph(seed=0, n=300):
    """Directed, weights in {0.5, 1, 2}: two hubs, heavy in the blocked
    tables, light vertices of degree 1..24, reverse edges for half of the
    edges, and ten sinks."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 25, n - 10)
    deg[:2] = (64, 80)
    src = np.repeat(np.arange(n - 10), deg).astype(np.int32)
    dst = rng.integers(0, n, len(src)).astype(np.int32)
    back = rng.random(len(src)) < 0.5
    src, dst = np.concatenate([src, dst[back]]), np.concatenate([dst, src[back]])
    keep = src < n - 10
    return src[keep], dst[keep], rng.choice(np.float32([0.5, 1.0, 2.0]), int(keep.sum()))


def _starts(n_vertices, n=600):
    starts = (np.arange(n) % n_vertices).astype(np.int32)
    starts[::13] = -1  # dead lanes
    return starts


def _blocked_tables(g):
    """JAX's blocked tables, without and with the shared lists, as the
    port's converter takes them, and the sharded walk's keywords."""
    out = {}
    for sl, trials in ((False, 2), (True, 64)):
        bg = ref_blocked.build_blocked_graph(g.indptr, g.indices, g.weights, shared_lists=sl)
        tables = dict(light=np.asarray(bg.light), biw=np.asarray(bg.biw),
                      bids=np.asarray(bg.bids), brp=np.asarray(bg.brp),
                      light_width=bg.light_width, block_width=bg.block_width,
                      has_heavy=bg.has_heavy,
                      slq=np.asarray(ref_blocked.slq_or_dummy(bg)) if sl else None,
                      sl_ovf_wfrac=bg.sl_ovf_wfrac)
        bkw = dict(max_trials=trials, light_width=bg.light_width, block_width=bg.block_width,
                   has_heavy=bg.has_heavy, shared_lists=sl, sl_exhaustive=bg.sl_exhaustive)
        out[f"blocked_sl{int(sl)}"] = (bg, tables, bkw)
    return out


def _dump(tmp_path_factory, name, obj) -> str:
    path = str(tmp_path_factory.mktemp("mesh") / f"{name}.pkl")
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    return path


@pytest.fixture(scope="module")
def walk_graph():
    src, dst, w = _graph()
    return (src, dst, w), from_edge_arrays(src, dst, w, directed=True)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, walk_graph):
    """The rank programs' results: world 2 (walks at 2 × 1 and the
    pipeline) and world 4 (walks at 4 × 1 and 2 × 2), one spawn each."""
    edges, g = walk_graph
    blocked = _blocked_tables(g)
    walk_case = dict(edges=edges, starts=_starts(g.n_vertices), gid_base=GID_BASE, seed=SEED,
                     walk_length=LENGTH, p=P, q=Q, engine_params=ENGINE,
                     blocked={k: v[1:] for k, v in blocked.items()},
                     shapes=SHAPES[2] + SHAPES[4])
    walk_path = _dump(tmp_path_factory, "walks", walk_case)
    pipe_path = _dump(tmp_path_factory, "pipeline", dict(
        shape=(2, 1), n2v=N2V, w2v=W2V, quality_n=600,
        quality_n2v=QUALITY_N2V, quality_w2v=QUALITY_W2V, epd=dict(EPD, draws=_epd_draws(2))))
    two = launch.spawn(torch_mesh_ranks.programs, 2, "gloo", "cpu",
                       [("mesh_and_walks", walk_path), ("pipeline", pipe_path)], timeout=600)
    four = launch.spawn(torch_mesh_ranks.programs, 4, "gloo", "cpu",
                        [("mesh_and_walks", walk_path)], timeout=600)
    return {2: [r[0] for r in two], 4: [r[0] for r in four], "pipeline": [r[1] for r in two]}


@pytest.fixture(scope="module")
def one_device(walk_graph):
    """The single-device engines' corpus (run, run_device), tail chunk,
    chunk size and blocked counts, by strategy."""
    _, g = walk_graph
    out = {}
    for strategy in ("dense", "blocked", "csr"):
        eng = WalkEngine(g, Node2VecParams(**ENGINE), strategy=strategy, device="cpu",
                         shared_lists=strategy == "blocked")
        n_chunks, chunk, source = eng.chunk_source(seed=SEED)
        assert n_chunks == 3 and chunk == 101
        want = eng.run(seed=SEED)
        np.testing.assert_array_equal(eng.run_device(seed=SEED).numpy(), want)
        tail = source(n_chunks - 1).numpy()
        out[strategy] = (want, tail, chunk, (eng.fallback_count, eng.attempt_count))
    return out


def _rank_results(ranks, shape):
    world = shape[0] * shape[1]
    return [r[f"{shape[0]}x{shape[1]}"] for r in ranks[world]]


# --------------------------------------------------------------------------- #
# the mesh
# --------------------------------------------------------------------------- #


def test_make_mesh_coordinates_and_validation(ranks):
    """At 2 × 2, rank r sits at (r // 2, r % 2), JAX's device grid; a mesh
    needing more ranks than the world has, a world that n_model does not
    divide, and a mesh leaving ranks out are ValueErrors."""
    for r, res in enumerate(ranks[4]):
        mesh = res["2x2"]
        assert res["rank"] == r
        assert mesh["coords"] == {"data": r // 2, "model": r % 2}
        assert mesh["shape"] == {"data": 2, "model": 2}
        assert mesh["axis_names"] == ("data", "model")
        assert "needs 8 ranks, have 4" in res["too_big"]
        assert "not divisible by n_model=3" in res["not_divisible"]
        assert "leaves 3 of 4 ranks out" in res["leaves_out"]
    assert [res["4x1"]["coords"] for res in ranks[4]] == [
        {"data": d, "model": 0} for d in range(4)]
    jax_mesh = ref_make_mesh(2, 2, devices=jax.devices()[:4])
    assert dict(jax_mesh.shape) == ranks[4][0]["2x2"]["shape"]


def test_world_of_one_and_initialize_distributed_is_a_noop():
    """Without a process group make_mesh makes a world of one (gloo on the
    CPU), as make_mesh() on one device gives 1 × 1 in JAX; once the group
    exists, initialize_distributed does nothing (the spawned ranks call it
    with an unreachable coordinator)."""
    import torch.distributed as dist

    from node2vec_torch.parallel import initialize_distributed

    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": dist.get_world_size(), "model": 1}
    assert mesh.backend == "gloo" and not mesh.host_staged
    initialize_distributed("127.0.0.1:1", 2, 1)
    assert dist.get_world_size() == 1
    t = torch.arange(4.0)
    assert torch.equal(mesh.all_reduce_sum(t.clone(), "model"), t)
    assert torch.equal(mesh.all_gather(t, "data"), t)
    assert mesh.collectives == {("all_reduce", "model"): 1, ("all_gather", "data"): 1}
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh.all_reduce_sum(t, "rows")


def test_spawn_fails_with_the_failing_rank_traceback():
    """A rank's exception fails spawn with that rank's traceback; the rank
    waiting for it in a collective does not hold the call up (it fails or
    is stopped)."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose") as err:
        launch.spawn(torch_mesh_ranks.fail_on_rank, 2, "gloo", "cpu", 1, timeout=120)
    message = str(err.value)
    assert "rank 1:\nTraceback" in message and "fail_on_rank" in message


# --------------------------------------------------------------------------- #
# the sharded walks
# --------------------------------------------------------------------------- #


def _jax_walks(g, edges, shape):
    """JAX's sharded dense, CSR and blocked walks at ``shape``."""
    mesh = ref_make_mesh(*shape, devices=jax.devices()[: shape[0] * shape[1]])
    g_ref = ref_from_edge_arrays(*edges, directed=True)
    starts = jnp.asarray(_starts(g.n_vertices))
    gids = jnp.arange(GID_BASE, GID_BASE + len(starts), dtype=jnp.int32)
    kw = dict(walk_length=LENGTH, return_param=P, inout_param=Q)
    eng = RefWalkEngine(g_ref, RefN2V(walk_length=LENGTH), strategy="dense")
    out = {"dense": np.asarray(ref_sharded_dense(mesh, eng.packed_adj, starts, gids,
                                                 jnp.uint32(SEED), **kw))}
    dg = g_ref.to_device()
    out["csr"] = np.asarray(ref_sharded_csr(
        mesh, dg.indptr, dg.indices, dg.weights, dg.alias, dg.prob, dg.wtot, starts, gids,
        jnp.uint32(SEED), search_iters=search_iters(int(np.diff(g.indptr).max())), **kw))
    for name, (bg, _, bkw) in _blocked_tables(g).items():
        paths, n_fb, n_att = ref_sharded_blocked(
            mesh, *bg[:4], ref_blocked.slq_or_dummy(bg), starts, gids, jnp.uint32(SEED),
            **bkw, **kw)
        out[name] = (np.asarray(paths), np.asarray(n_fb), np.asarray(n_att))
    return out


@pytest.mark.parametrize("shape", SHAPES[2] + SHAPES[4], ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_walks_bit_equal_jax(ranks, walk_graph, shape):
    """Each rank's rows of the three sharded walk functions are its data
    coordinate's rows of JAX's; the blocked shard's trial-capped and attempt
    counts are JAX's per-shard counts."""
    edges, g = walk_graph
    want = _jax_walks(g, edges, shape)
    n_local = len(_starts(g.n_vertices)) // shape[0]
    for res in _rank_results(ranks, shape):
        d = res["coords"]["data"]
        rows = slice(d * n_local, (d + 1) * n_local)
        np.testing.assert_array_equal(res["dense"], want["dense"][rows])
        np.testing.assert_array_equal(res["csr"], want["csr"][rows])
        for name in ("blocked_sl0", "blocked_sl1"):
            paths, n_fb, n_att = res[name]
            w_paths, w_fb, w_att = want[name]
            np.testing.assert_array_equal(paths, w_paths[rows])
            assert (n_fb, n_att) == (int(w_fb[d]), int(w_att[d])), name
    # the shards are not copies of one another, and the trial cap bit
    assert sum(int(w) for w in want["blocked_sl0"][1]) > 0
    assert not np.array_equal(want["dense"][:n_local], want["dense"][n_local: 2 * n_local])


@pytest.mark.parametrize("shape", SHAPES[2] + SHAPES[4], ids=lambda s: f"{s[0]}x{s[1]}")
def test_walk_engine_on_a_mesh_equals_one_device(ranks, one_device, shape):
    """WalkEngine(mesh=) gives every rank the single-device engine's corpus
    from run, run_device and chunk_source (chunks of 101 walkers, padded
    to the data axis), and its counts sum over the data shards."""
    for strategy in ("dense", "blocked", "csr"):
        want, tail, chunk, counts = one_device[strategy]
        for res in _rank_results(ranks, shape):
            got = res["engine_" + strategy]
            np.testing.assert_array_equal(got["run"], want)
            np.testing.assert_array_equal(got["run_device"], want)
            np.testing.assert_array_equal(got["tail_chunk"], tail)
            assert got["chunk"] == chunk
            if strategy == "blocked":
                assert (got["fallback"], got["attempts"]) == counts
                assert got["attempts"] > 0


# --------------------------------------------------------------------------- #
# Node2Vec(mesh=)
# --------------------------------------------------------------------------- #


def test_pipeline_walks_bit_equal_jax_and_trains(ranks, karate_edges):
    """At 2 × 1 on karate (tests/test_sharded.py:182-212): random_walk()
    equals JAX's Node2Vec(mesh=) walks; fit(), embedding() and
    run_pipeline() give every rank the same finite vectors."""
    src, dst = karate_edges
    np.testing.assert_array_equal(np.stack(torch_mesh_ranks.karate()), np.stack(karate_edges))
    ref = node2vec_tpu.Node2Vec(n2v_params=N2V, w2v_params=W2V, random_seed=3,
                                mesh=ref_make_mesh(2, 1, devices=jax.devices()[:2]))
    ref.preprocess_input_graph((src, dst), indexed=True, directed=False)
    want = ref.random_walk()
    first = ranks["pipeline"][0]
    for res in ranks["pipeline"]:
        np.testing.assert_array_equal(res["walks"], want)
        losses, names, vectors = res["fit"]
        assert len(losses) == W2V["max_iter"] and all(np.isfinite(losses))
        assert vectors.shape == (34, 32) and np.isfinite(vectors).all()
        assert sorted(names.tolist()) == list(range(34))
        np.testing.assert_array_equal(vectors, first["fit"][2])  # replicas agree
        losses, vectors, walks = res["run_pipeline"]
        np.testing.assert_array_equal(walks, want)
        assert np.isfinite(vectors).all() and all(np.isfinite(losses))
        np.testing.assert_array_equal(vectors, first["run_pipeline"][1])


def test_pipeline_quality_close_to_jax(ranks):
    """Node2Vec(mesh=) at 2 × 1 through run_pipeline (fit_sharded, column)
    on the quality graph: micro-F1@0.5 within 0.05 of JAX's column trainer,
    as tests/test_torch_pipeline.py holds the single-device path."""
    g, labels = synthetic_multilabel(600, seed=0)
    ref_g, ref_labels = node2vec_tpu.datasets.synthetic_multilabel(600, seed=0)
    np.testing.assert_array_equal(ref_labels, labels)
    ref = node2vec_tpu.Node2Vec(RefN2V(**QUALITY_N2V), RefW2V(**QUALITY_W2V), random_seed=0,
                                mesh=ref_make_mesh(2, 1, devices=jax.devices()[:2]))
    ref.graph = ref_g
    want = multilabel_f1(np.asarray(ref.run_pipeline().vectors), labels, 0.5, 0)["micro_f1"]
    got = multilabel_f1(ranks["pipeline"][0]["quality"], labels, 0.5, 0)["micro_f1"]
    assert got >= 0.55, got
    assert abs(got - want) <= 0.05, (got, want)


def test_pipeline_mesh_cases_that_still_raise(ranks, karate_edges):
    """The row layout trains at 2 x 1 (fit with "row", run_pipeline
    streaming into fit_streaming_sharded: finite losses and vectors, the
    same on both ranks); the graph-sharded walks (strategy "ep_blocked")
    give the walker-sharded blocked engine's corpus; the round-1 dense
    edge-partitioned walk gives JAX's rows at 2 x 1 given its draws; what
    still raises: host_corpus with a mesh, JAX's ValueError."""
    res = ranks["pipeline"][0]
    assert len(res["row_fit"]) == W2V["max_iter"] and all(np.isfinite(res["row_fit"]))
    losses, vectors, walks = res["row_streaming"]
    assert len(losses) == W2V["max_iter"] and all(np.isfinite(losses)) and walks is None
    assert vectors.shape == (34, 32) and np.isfinite(vectors).all()
    np.testing.assert_array_equal(ranks["pipeline"][1]["row_streaming"][1], vectors)
    walks, strategy, replicated = res["graph_sharded_walks"]
    assert strategy == "ep_blocked"
    np.testing.assert_array_equal(walks, replicated)
    g = ref_from_edge_arrays(*karate_edges, directed=False)
    mesh = ref_make_mesh(2, 1, devices=jax.devices()[:2])
    padded, rps = ref_partition(np.asarray(ref_packed(g.indptr, g.indices, g.weights)), 2)
    want = np.asarray(ref_epd_walk(mesh, jnp.asarray(padded), rps, jnp.asarray(EPD["starts"]),
                                   jax.random.PRNGKey(EPD["seed"]),
                                   walk_length=EPD["walk_length"], return_param=EPD["p"],
                                   inout_param=EPD["q"]))
    for rank in ranks["pipeline"]:
        np.testing.assert_array_equal(rank["graph_sharded"], want)
    assert "host_corpus" in res["host_corpus"]
