"""node2vec_torch's graph-sharded (edge-partitioned) blocked walks against
its single-device blocked walk and node2vec_tpu's on the CPU.

The port's ranks run in spawned processes over gloo (world sizes 1, 2 and
4, one spawn each, from ``tests/torch_ep_ranks.py``, which imports no
JAX), while this process computes the references: the port's
``blocked_walk_chunk_plain`` and, on its virtual CPU devices at the same
world sizes, the JAX package's ``edge_partitioned_blocked_walk``,
partitions, saved shards, engine and ``run_quality``.  Every walk
comparison is bit-equality (paths, unfinished and fallback counts): the
draws are keyed on (seed, walker, attempt) and a deferred attempt replays
its counter, so the superstep exchanges cannot change a walk.  Against the
port's own blocked walk that holds on any weights (both packages sum the
same rows in torch); against JAX on weights in {0.5, 1, 2} and p, q powers
of two, where every partial sum is exact.  Tables and metadata are
compared bit for bit; ``run_quality`` on the mesh within 0.05 micro-F1 of
JAX's.
"""

import concurrent.futures
import pickle
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from node2vec_tpu import native as ref_native
from node2vec_tpu.constants import Node2VecParams as RefN2V
from node2vec_tpu.constants import Word2VecParams as RefW2V
from node2vec_tpu.datasets import run_quality as ref_run_quality
from node2vec_tpu.datasets import synthetic_multilabel as ref_synthetic_multilabel
from node2vec_tpu.graph import build_graph as ref_build_graph
from node2vec_tpu.graph import from_edge_arrays as ref_from_edge_arrays
from node2vec_tpu.parallel import edge_partitioned_blocked as ref_ep
from node2vec_tpu.walk import WalkEngine as RefWalkEngine
from node2vec_tpu.walk import blocked as ref_blocked
from node2vec_torch import Node2Vec
from node2vec_torch.constants import Node2VecParams
from node2vec_torch.graph import from_edge_arrays
from node2vec_torch.parallel import edge_partitioned_blocked as ep
from node2vec_torch.parallel import launch, make_mesh
from node2vec_torch.walk import WalkEngine, blocked

import torch_ep_ranks

WORLDS = (1, 2, 4)
GRAPHS = dict(hub=dict(with_far=True), hub_dyadic=dict(with_far=True, dyadic=True),
              hub601=dict(hub_deg=601, dyadic=True))
PQ = ((1.0, 1.0), (0.25, 4.0), (4.0, 0.25))
RANGED_PQ = ((0.25, 4.0), (4.0, 0.25))
ENGINE = dict(graph="hub_dyadic", seed=4,
              params=dict(num_walks=2, walk_length=5, return_param=0.5, inout_param=2.0))
PIPE = dict(n2v=dict(num_walks=2, walk_length=6, return_param=0.5, inout_param=2.0),
            w2v=dict(vector_size=32, max_iter=1, min_count=1, batch_walks=64))
QUALITY = dict(n=600, n2v=dict(num_walks=6, walk_length=20),
               w2v=dict(min_count=1, max_iter=3, vector_size=32))


def _ref_native_loaded(deadline_s: float = 120.0) -> None:
    """Load the JAX package's native library, waiting out a concurrent build
    by another test worker (it compiles in place); fails if it never loads."""
    t_end = time.monotonic() + deadline_s
    while not ref_native.available():
        if time.monotonic() > t_end:
            pytest.fail(f"{ref_native._LIB_PATH} did not load within {deadline_s:.0f} s")
        time.sleep(0.5)


def _starts(seed: int, n_vertices: int, w: int = 512) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, n_vertices, w).astype(np.int32)


def _walk_cases(n_v: dict) -> dict:
    """name -> (graph, starts, walk settings, ranged_metadata): the JAX
    package's test_ep_blocked.py cases, on the port's graphs."""
    base = dict(walk_length=12, seed=5)
    cases = {f"pq_{p}_{q}": ("hub", _starts(0, n_v["hub"]),
                             dict(base, return_param=p, inout_param=q), False) for p, q in PQ}
    cases["approx"] = ("hub", _starts(2, n_v["hub"]),
                       dict(base, return_param=0.25, inout_param=4.0, max_trials=1), False)
    cases["dyadic"] = ("hub_dyadic", _starts(0, n_v["hub_dyadic"]),
                       dict(base, return_param=0.25, inout_param=4.0), False)
    cases["dyadic_approx"] = ("hub_dyadic", _starts(2, n_v["hub_dyadic"]),
                              dict(base, return_param=0.25, inout_param=4.0, max_trials=1), False)
    cases["deferral"] = ("hub_dyadic", _starts(1, n_v["hub_dyadic"], 256),
                         dict(walk_length=8, seed=9, return_param=0.5, inout_param=2.0,
                              capacity=4, slack=64), False)
    cases["truncation"] = ("hub_dyadic", np.zeros(512, np.int32),
                           dict(walk_length=8, seed=2, return_param=1.0, inout_param=1.0,
                                capacity=1, slack=1), False)
    cases["padding"] = ("hub601", np.array([0, 1, 2, 3, 4, 5, 6, -1], np.int32),
                        dict(walk_length=4, seed=0, return_param=1.0, inout_param=1.0), False)
    for p, q in RANGED_PQ:
        cases[f"ranged_{p}_{q}"] = ("hub", _starts(3, n_v["hub"]),
                                    dict(base, return_param=p, inout_param=q), True)
    return cases


# the cases held against JAX's ep walk, and at which world sizes
JAX_CASES = {"dyadic": WORLDS, "dyadic_approx": WORLDS, "deferral": WORLDS,
             "truncation": WORLDS, "padding": (2, 4)}


def _jax_mesh(n: int) -> JaxMesh:
    return JaxMesh(np.array(jax.devices()[:n]).reshape(n, 1), ("data", "model"))


def _ref_graph(edges):
    return ref_from_edge_arrays(*edges, directed=True)


def _jax_walk(g, n, starts, walk):
    pg = ref_ep.partition_blocked_graph(g.indptr, g.indices, g.weights, n, mesh=_jax_mesh(n))
    kw = {k: walk[k] for k in ("max_trials", "capacity", "slack") if k in walk}
    paths, unfin, fb = ref_ep.edge_partitioned_blocked_walk(
        _jax_mesh(n), pg, jnp.asarray(starts), jnp.arange(len(starts), dtype=jnp.int32),
        jnp.uint32(walk["seed"]), walk_length=walk["walk_length"],
        return_param=walk["return_param"], inout_param=walk["inout_param"], **kw)
    return np.asarray(paths), int(np.asarray(unfin).sum()), int(np.asarray(fb).sum())


def _plain_blocked(g, starts, walk):
    """The port's single-device blocked walk: (paths, fallbacks)."""
    bg = blocked.build_blocked_graph(g.indptr, g.indices, g.weights, device="cpu")
    paths, n_fb, _ = blocked.blocked_walk_chunk_plain(
        *bg[:4], torch.from_numpy(starts), 0, walk["seed"], walk_length=walk["walk_length"],
        return_param=walk["return_param"], inout_param=walk["inout_param"],
        max_trials=walk.get("max_trials", 64), light_width=bg.light_width,
        block_width=bg.block_width, has_heavy=bg.has_heavy)
    return paths.numpy(), int(n_fb)


def _dump(tmp_path_factory, name, obj) -> str:
    path = str(tmp_path_factory.mktemp("ep") / f"{name}.pkl")
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results at worlds 1, 2 and 4 (each spawn running while
    this process computes the references), the plain blocked walks, and
    JAX's walks, saved shards, engine corpus and quality."""
    _ref_native_loaded()
    edges = {name: torch_ep_ranks.hub_edges(**kw) for name, kw in GRAPHS.items()}
    port_g = {name: from_edge_arrays(*e, directed=True) for name, e in edges.items()}
    ref_g = {name: _ref_graph(e) for name, e in edges.items()}
    cases = _walk_cases({name: g.n_vertices for name, g in port_g.items()})
    saved = {}
    g_eng = ref_g[ENGINE["graph"]]
    for n in WORLDS:
        saved[n] = str(tmp_path_factory.mktemp(f"jax_saved_{n}"))
        ref_ep.save_partitioned_graph(saved[n], g_eng.indptr, g_eng.indices, g_eng.weights, n)
    pool = concurrent.futures.ThreadPoolExecutor(len(WORLDS))
    futures = {}
    for n in reversed(WORLDS):
        case = dict(graphs=edges, walks=cases, engine_walk=ENGINE, jax_saved=saved[n])
        if n == 2:
            case.update(pipeline=PIPE, quality=QUALITY)
        futures[n] = pool.submit(launch.spawn, torch_ep_ranks.programs, n, "gloo", "cpu",
                                 _dump(tmp_path_factory, f"world{n}", case), timeout=600)
    plain = {name: _plain_blocked(port_g[g], starts, walk)
             for name, (g, starts, walk, _) in cases.items()}
    jax_walks = {(name, n): _jax_walk(ref_g[cases[name][0]], n, cases[name][1], cases[name][2])
                 for name, worlds in JAX_CASES.items() for n in worlds}
    eng_params = RefN2V(**ENGINE["params"])
    jax_engine = RefWalkEngine(g_eng, eng_params, mesh=_jax_mesh(2),
                               graph_sharded=True).run(seed=ENGINE["seed"])
    gq, labels = ref_synthetic_multilabel(QUALITY["n"], seed=0)
    jax_quality = ref_run_quality(gq, labels, RefN2V(**QUALITY["n2v"]),
                                  RefW2V(**QUALITY["w2v"]), train_ratios=(0.5,),
                                  mesh=_jax_mesh(2))["micro_f1@0.5"]
    ranks = {n: f.result() for n, f in futures.items()}
    pool.shutdown()
    return dict(edges=edges, port_g=port_g, ref_g=ref_g, cases=cases, plain=plain,
                jax=jax_walks, jax_engine=jax_engine, jax_quality=jax_quality, saved=saved,
                ranks=ranks)


def _rank_walks(runs, name):
    """{world: (paths, unfinished, fallbacks)} of ``name``, every rank's
    gathered corpus equal to rank 0's."""
    out = {}
    for n, results in runs["ranks"].items():
        first = results[0]["walks"][name]
        for r in results[1:]:
            np.testing.assert_array_equal(r["walks"][name][0], first[0])
            assert r["walks"][name][1:] == first[1:]
        out[n] = first
    return out


@pytest.mark.parametrize("p,q", PQ)
def test_bitmatch_single_device(runs, p, q):
    """Bit-equal to the port's blocked walk on the JAX test's hub graph
    (weights uniform in [0.5, 2)), at S = 1, 2, 4; nothing unfinished."""
    ref, _ = runs["plain"][f"pq_{p}_{q}"]
    for n, (paths, unfin, _) in _rank_walks(runs, f"pq_{p}_{q}").items():
        np.testing.assert_array_equal(paths, ref, err_msg=f"S = {n}")
        assert unfin == 0


def test_bitmatch_approx_mode(runs):
    """Trial cap 1: forced accepts keyed on the same counters, the same
    fallback count as the blocked walk's, and the cap bites."""
    ref, ref_fb = runs["plain"]["approx"]
    assert ref_fb > 0
    for n, (paths, unfin, fb) in _rank_walks(runs, "approx").items():
        np.testing.assert_array_equal(paths, ref, err_msg=f"S = {n}")
        assert (unfin, fb) == (0, ref_fb), n


@pytest.mark.parametrize("name", ["dyadic", "dyadic_approx"])
def test_bitmatch_jax_ep_walk(runs, name):
    """Dyadic weights, p and q powers of two: paths, unfinished and
    fallbacks equal to JAX's ep walk at the same S (and the blocked walk's)."""
    ref, ref_fb = runs["plain"][name]
    got = _rank_walks(runs, name)
    for n in JAX_CASES[name]:
        want = runs["jax"][(name, n)]
        np.testing.assert_array_equal(got[n][0], want[0], err_msg=f"S = {n}")
        assert got[n][1:] == want[1:], n
    for n, (paths, unfin, fb) in got.items():
        np.testing.assert_array_equal(paths, ref, err_msg=f"S = {n}")
        assert (unfin, fb) == (0, ref_fb)


def test_deferral_preserves_walks(runs):
    """Capacity 4 defers lanes every superstep; the walks stay the blocked
    walk's and equal JAX's at every S."""
    ref, _ = runs["plain"]["deferral"]
    got = _rank_walks(runs, "deferral")
    for n, (paths, unfin, _) in got.items():
        np.testing.assert_array_equal(paths, ref, err_msg=f"S = {n}")
        assert unfin == 0
    for n in JAX_CASES["deferral"]:
        np.testing.assert_array_equal(got[n][0], runs["jax"][("deferral", n)][0])


def test_truncation_is_reported(runs):
    """Capacity 1 and slack 1 with every walker at the hub: walkers stop at
    the bound and are counted, as many as JAX counts, with the same
    contiguous prefixes."""
    got = _rank_walks(runs, "truncation")
    for n in WORLDS:
        paths, unfin, _ = got[n]
        assert unfin > 0, n
        valid = paths >= 0
        assert not ((~valid[:, :-1]) & valid[:, 1:]).any()
        assert (paths[:, 0] == 0).all()
        assert unfin == int((paths[:, -1] < 0).sum())
    for n in JAX_CASES["truncation"]:
        np.testing.assert_array_equal(got[n][0], runs["jax"][("truncation", n)][0])
        assert got[n][1:] == runs["jax"][("truncation", n)][1:]


def test_partition_covers_padding_vertices(runs):
    """V = 603 splits unevenly: the padded vertices are isolated, every
    start keeps its vertex, the dead lane stays -1, as in JAX."""
    got = _rank_walks(runs, "padding")
    starts = runs["cases"]["padding"][1]
    for n, (paths, _, _) in got.items():
        assert (paths[:7, 0] == starts[:7]).all()
        assert (paths[7] == -1).all()
        np.testing.assert_array_equal(paths, runs["plain"]["padding"][0])
    for n in JAX_CASES["padding"]:
        np.testing.assert_array_equal(got[n][0], runs["jax"][("padding", n)][0])


@pytest.mark.parametrize("p,q", RANGED_PQ)
def test_ranged_pack_bitmatches_single_device(runs, p, q):
    """Tables packed with the range-exchange metadata (exact triangle bits)
    walk bit-equal to the blocked walk on the global metadata."""
    ref, _ = runs["plain"][f"ranged_{p}_{q}"]
    for n, (paths, unfin, _) in _rank_walks(runs, f"ranged_{p}_{q}").items():
        np.testing.assert_array_equal(paths, ref, err_msg=f"S = {n}")
        assert unfin == 0


def test_walk_engine_graph_sharded(runs):
    """WalkEngine(mesh=, graph_sharded=True): strategy and checkpoint token
    "ep_blocked", the single-device engine's corpus on every rank (JAX's
    engine's at S = 2), nothing unfinished, no fallback, supersteps counted
    a chunk; the same through JAX's saved shards loaded with the mesh."""
    g = runs["port_g"][ENGINE["graph"]]
    want = WalkEngine(g, Node2VecParams(**ENGINE["params"]), strategy="blocked",
                      device="cpu").run(seed=ENGINE["seed"])
    np.testing.assert_array_equal(runs["jax_engine"], want)
    for n, results in runs["ranks"].items():
        for r in results:
            strategy, token, walks, unfin, fb, steps = r["engine"]
            assert (strategy, token, unfin, fb) == ("ep_blocked", "ep_blocked", 0, 0)
            assert len(steps) == 1 and 0 < steps[0] <= ep.max_supersteps(5, 2.0)
            np.testing.assert_array_equal(walks, want, err_msg=f"S = {n}")
            np.testing.assert_array_equal(r["engine_loaded"], want)


def test_public_api_graph_sharded(runs):
    """Node2Vec(mesh=, graph_sharded=True) at 2 x 1: random_walk() equals
    the single-device pipeline's walks, and run_pipeline() trains both
    table layouts to finite losses, the same vectors on both ranks."""
    src, dst, w = runs["edges"]["hub"]
    one = Node2Vec(n2v_params=PIPE["n2v"], w2v_params=PIPE["w2v"], device="cpu")
    one.preprocess_input_graph((src, dst, w), indexed=True, directed=True)
    want = one.random_walk()
    results = runs["ranks"][2]
    for layout in ("column", "row"):
        walks, strategy, losses, vectors = results[0][f"pipeline_{layout}"]
        assert strategy == "ep_blocked"
        np.testing.assert_array_equal(walks, want)
        assert len(losses) == PIPE["w2v"]["max_iter"] and np.isfinite(losses).all()
        assert np.isfinite(vectors).all()
        np.testing.assert_array_equal(results[1][f"pipeline_{layout}"][3], vectors)


def test_partition_tables_match_jax(runs):
    """The port's partition, every shard on the CPU and each rank's shard on
    its mesh, bit-equal to JAX's partition (both native packers)."""
    edges = runs["edges"]["hub"]
    g, rg = runs["port_g"]["hub"], runs["ref_g"]["hub"]
    for n in WORLDS:
        want = ref_ep.partition_blocked_graph(rg.indptr, rg.indices, rg.weights, n)
        got = ep.partition_blocked_graph(g.indptr, g.indices, g.weights, n)
        assert got.shards is None
        assert got[4:9] == tuple(want[4:9])
        for name in ("light", "biw", "bids", "brp"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
        for rank, r in enumerate(runs["ranks"][n]):
            *tables, shards = r["tables"]["partition"]
            assert shards == (rank,)
            for t, full in zip(tables, ep.local_tables(got, rank)):
                np.testing.assert_array_equal(t, full.numpy())
    assert len(edges[0]) == g.n_edges


def test_save_load_partitioned_roundtrip(runs, tmp_path):
    """The shard files cross packages both ways bit-equal (a selective load
    too), and each rank loads its own shard of JAX's files with its mesh."""
    g, rg = runs["port_g"]["hub_dyadic"], runs["ref_g"]["hub_dyadic"]
    ep.save_partitioned_graph(str(tmp_path / "port"), g.indptr, g.indices, g.weights, 4)
    direct = ep.partition_blocked_graph(g.indptr, g.indices, g.weights, 4)
    from_port = ref_ep.load_partitioned_graph(str(tmp_path / "port"))
    from_jax = ep.load_partitioned_graph(runs["saved"][4])
    part = ep.load_partitioned_graph(str(tmp_path / "port"), shards=[3])
    assert part.shards == (3,)
    for name in ("light", "biw", "bids", "brp"):
        want = getattr(direct, name).numpy()
        np.testing.assert_array_equal(np.asarray(getattr(from_port, name)), want)
        np.testing.assert_array_equal(getattr(from_jax, name).numpy(), want)
    for t, full in zip(part[:4], ep.local_tables(direct, 3)):
        np.testing.assert_array_equal(t.numpy(), full.numpy())
    assert tuple(from_port[4:9]) == direct[4:9] == from_jax[4:9]
    for n, results in runs["ranks"].items():
        direct_n = ep.partition_blocked_graph(g.indptr, g.indices, g.weights, n)
        for rank, r in enumerate(results):
            *tables, shards = r["tables"]["jax_saved"]
            assert shards == (rank,)
            for t, full in zip(tables, ep.local_tables(direct_n, rank)):
                np.testing.assert_array_equal(t, full.numpy())
    with pytest.raises(ValueError, match="holds shards"):
        ep.local_tables(part, 0)


def test_ranged_metadata_matches_global_and_jax():
    """The range-exchange pass gives the global pass's rev weights,
    prefixes and exact triangle bits, and JAX's arrays bit for bit."""
    _ref_native_loaded()
    g = torch_ep_ranks.hub_graph(with_far=True)
    ref_rev, ref_pfx = blocked._edge_metadata(g.indptr, g.indices, g.weights)
    assert (ref_rev & blocked.SIGN != 0).any() and (ref_rev & blocked.SIGN == 0).any()
    for n_ranges in (1, 3, 8):
        rev, pfx = blocked._edge_metadata_ranged(g.indptr, g.indices, g.weights, n_ranges)
        np.testing.assert_array_equal(rev & blocked.MAG, ref_rev & blocked.MAG)
        np.testing.assert_allclose(pfx, ref_pfx, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(rev & blocked.SIGN, ref_rev & blocked.SIGN)
        j_rev, j_pfx = ref_blocked._edge_metadata_ranged(g.indptr, g.indices, g.weights,
                                                         n_ranges)
        np.testing.assert_array_equal(rev, np.asarray(j_rev))
        np.testing.assert_array_equal(pfx, np.asarray(j_pfx))


def test_ranged_metadata_exact_bits_random():
    """Exact triangle bits on a messy undirected graph (hubs, self loops,
    isolated vertices) for several range counts, as JAX's test."""
    from node2vec_torch.graph import build_graph

    rng = np.random.default_rng(11)
    n_v = 400
    src = np.concatenate([rng.zipf(1.6, 3000) % n_v, rng.integers(0, 40, 500),
                          np.arange(0, 20), [n_v + 49]]).astype(np.int32)
    dst = np.concatenate([rng.integers(0, n_v, 3000), rng.integers(0, 40, 500),
                          np.arange(0, 20), [0]]).astype(np.int32)
    g = build_graph((src, dst), indexed=True, directed=False)
    rg = ref_build_graph((src, dst), indexed=True, directed=False)
    np.testing.assert_array_equal(g.indices, rg.indices)
    ref_rev, _ = blocked._edge_metadata(g.indptr, g.indices, g.weights)
    for n_ranges in (2, 5, 16):
        rev, _ = blocked._edge_metadata_ranged(g.indptr, g.indices, g.weights, n_ranges)
        np.testing.assert_array_equal(rev, ref_rev)


def test_ranged_metadata_pack_walks(tmp_path):
    """A ranged-metadata pack saved to disk and loaded drives the engine on
    a world of one: complete walks (the hub graph has no sinks), equal to
    the global pack's."""
    g = torch_ep_ranks.hub_graph()
    ep.save_partitioned_graph(str(tmp_path), g.indptr, g.indices, g.weights, 1,
                              ranged_metadata=True)
    mesh = make_mesh(device="cpu")
    params = Node2VecParams(num_walks=4, walk_length=6, return_param=0.5, inout_param=2.0)
    loaded = ep.load_partitioned_graph(str(tmp_path), mesh=mesh)
    assert loaded.shards == (0,)
    w = WalkEngine(g, params, mesh=mesh, graph_sharded=True, partitioned_graph=loaded,
                   device="cpu").run(seed=11)
    assert w.shape == (4 * g.n_vertices, 7) and (w >= 0).all()
    np.testing.assert_array_equal(
        w, WalkEngine(g, params, mesh=mesh, graph_sharded=True, device="cpu").run(seed=11))


def test_bucket_matches_jax_bucket_by_dest():
    """K20's plain version ranks lanes as JAX's _bucket_by_dest (stable in
    lane order, deferral past capacity) and packs the proposal request."""
    rng = np.random.default_rng(7)
    n, n_shards, cap, v_p = 300, 4, 20, 50
    carry = ep.init_carry(torch.from_numpy(rng.integers(-1, 200, n).astype(np.int32)))
    carry[ep.T] = torch.from_numpy(rng.integers(0, 6, n).astype(np.int32))
    carry[ep.ATT] = torch.from_numpy(rng.integers(0, 9, n).astype(np.int32))
    send, slot = ep.ep_bucket_plain(carry, 3, 1000, n_shards=n_shards, capacity=cap,
                                    rows_per_shard=v_p, walk_length=5)
    active = (carry[ep.ALIVE] != 0) & (carry[ep.T] < 5)
    dest = np.where(active, np.minimum(carry[ep.CUR].numpy() // v_p, n_shards - 1), 0)
    want_slot, sendable = ref_ep._bucket_by_dest(jnp.asarray(dest), jnp.asarray(active.numpy()),
                                                 n_shards, cap)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(want_slot))
    assert 0 < int(np.asarray(sendable).sum()) < int(active.sum())  # some lanes defer
    sent = slot.numpy() < n_shards * cap
    np.testing.assert_array_equal(send.numpy()[slot.numpy()[sent], 0], carry[ep.CUR].numpy()[sent])
    assert (send.numpy()[np.setdiff1d(np.arange(n_shards * cap), slot.numpy()[sent])] == -1).all()


def test_graph_sharded_needs_a_mesh_and_the_dense_variant_raises():
    """graph_sharded=True and strategy "ep_blocked" without a mesh are
    ValueErrors; the round-1 dense variant (ROADMAP A12.5) no longer raises:
    ``partition_packed_adjacency`` pads the packed rows and
    ``edge_partitioned_walk`` walks them on a gloo world of one."""
    from node2vec_torch.parallel import edge_partitioned_walk, partition_packed_adjacency
    from node2vec_torch.walk.dense import build_padded_adjacency

    g = torch_ep_ranks.hub_graph()
    for kw in (dict(graph_sharded=True), dict(strategy="ep_blocked")):
        with pytest.raises(ValueError, match="requires a mesh"):
            WalkEngine(g, Node2VecParams(), device="cpu", **kw)
    packed = build_padded_adjacency(g.indptr, g.indices, g.weights)
    padded, rps = partition_packed_adjacency(packed, 1)
    np.testing.assert_array_equal(padded, packed)
    starts = torch.arange(8, dtype=torch.int32)
    paths = edge_partitioned_walk(make_mesh(device="cpu"), torch.from_numpy(padded), rps, starts,
                                  0, walk_length=4, return_param=0.5, inout_param=2.0)
    assert paths.shape == (8, 5) and (paths >= 0).all()
    adj = {v: set(g.neighbors(v)[0].tolist()) for v in range(g.n_vertices)}
    assert all(int(b) in adj[int(a)] for row in paths for a, b in zip(row[:-1], row[1:]))


def test_run_quality_on_mesh_close_to_jax(runs):
    """run_quality(mesh=) at 2 x 1 (walks on the mesh, the row layout)
    within 0.05 micro-F1@0.5 of JAX's run_quality on its 2 x 1 mesh."""
    got = [r["quality"] for r in runs["ranks"][2]]
    assert got[0] == got[1]
    assert abs(got[0] - runs["jax_quality"]) <= 0.05, (got[0], runs["jax_quality"])


def test_run_readback_thread_count_invariant():
    """run(readback_threads=) is taken as the JAX engine takes it; the
    corpus is the same at 1 and 16 threads (tests/test_fit_host.py:138)."""
    g = torch_ep_ranks.hub_graph()
    params = Node2VecParams(num_walks=3, walk_length=8, walker_chunk=500)
    w1 = WalkEngine(g, params, device="cpu").run(seed=5, readback_threads=1)
    w16 = WalkEngine(g, params, device="cpu").run(seed=5, readback_threads=16)
    np.testing.assert_array_equal(w1, w16)

