"""node2vec_torch's row-sharded trainers (``parallel.rowsharded_sgns``,
``parallel.rowsharded_hs``, ``Word2VecTorch.fit_sharded(table_sharding=
"row")``, ``fit_streaming_sharded``, ``Node2Vec(mesh=, table_sharding=
"row")``) against node2vec_tpu's on the CPU.

The port's ranks run in spawned processes over gloo
(``node2vec_torch.parallel.launch.spawn``, world sizes 1 and 2), from
``tests/torch_row_ranks.py``, which imports no JAX; the JAX package runs in
this process on its virtual CPU devices at the same flat device counts
(meshes N x 1 over ("data", "model")).

* K18's plain version (the port's ``plan_routes`` on CPU tensors) is
  bit-equal to JAX's ``_plan_routes`` in every field, at N = 1, 2, 4, on
  ids with repeats, with the -1 -> 0 mapped zeros, and with a capacity that
  overflows (rowsharded_sgns.py:170-203, tests/test_rowsharded.py:29-55).
* The routed SGNS step (two steps on one batch) and epoch start from JAX's
  full tables (``convert.from_reference_row_state``) and take JAX's draws:
  a step's key folded with the flat device, ``fold_in(key, my)``, split
  into (negatives 1, negatives 2, shrink); an epoch's step keys
  ``fold_in(key, gstep)`` and each rank's shuffle
  ``permutation(fold_in(fold_in(key, my), 0x5F5E1))``.  Tables,
  accumulators and losses to rtol 1e-5, atol 1e-6 (sums in another order),
  the dropped counts equal, also with a capacity of 8 that drops rows.
* The routed HS step and epoch, with a head (levels 0-2 replicated) and
  without, on bf16-exact tables: the tables' increments to 3e-2 of their
  largest, the losses to rtol 1e-4 (the HS tolerances of
  tests/test_torch_hsoftmax.py), dropped counts equal.
* At N = 1 the routing is the identity: the routed steps equal the
  single-device steps (``sgns_walk_step_plain``, ``hs_walk_step_plain``).
* The trainers at world 2 on karate: finite falling losses, the same full
  tables on every rank, K7 from a rank's position equal to K7 on the whole
  corpus, a train state JAX wrote resumed and the port's resumed by JAX's
  ``fit_sharded``, ``fit_streaming_sharded`` stopped mid-epoch and resumed
  bit-equal to the uninterrupted run, a stream-state file JAX wrote (its
  fingerprint, its row layout) resumed, and the guards.
* ``fit_streaming_sharded``'s chunk loop against JAX's on the same chunks,
  each row epoch replaced by a recorder in both packages: every call's rank
  rows (chunk order, padding, stride-interleave), step0, LR slope,
  batch_local, n_batches and step key equal.
* ``Node2Vec(mesh=, table_sharding="row")``: random_walk + fit and
  run_pipeline for SGNS and HS, and micro-F1 on the quality graph within
  0.05 of JAX's row trainer.
"""

import concurrent.futures
import functools
import os
import pickle
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec as P

import node2vec_tpu
import node2vec_tpu.datasets
from node2vec_tpu.constants import Node2VecParams as RefN2V
from node2vec_tpu.constants import Word2VecParams as RefW2V
from node2vec_tpu.graph import from_edge_arrays as ref_from_edge_arrays
from node2vec_tpu.models import Word2VecTPU
from node2vec_tpu.models.hsoftmax import build_huffman as ref_build_huffman
from node2vec_tpu.ops.alias import build_alias_csr
from node2vec_tpu.parallel import rowsharded_hs as ref_rh
from node2vec_tpu.parallel import rowsharded_sgns as ref_rs
from node2vec_tpu.utils import checkpoint as ref_ck
from node2vec_tpu.walk import WalkEngine as RefWalkEngine
from node2vec_torch.constants import Node2VecParams
from node2vec_torch.datasets import multilabel_f1, synthetic_multilabel
from node2vec_torch.graph import from_edge_arrays
from node2vec_torch.models.hsoftmax import head_level_offsets
from node2vec_torch.models.vocab import subsample_walks_plain
from node2vec_torch.parallel import launch
from node2vec_torch.parallel import rowsharded_sgns as rs
from node2vec_torch.walk import random_walks

import torch_mesh_ranks
import torch_row_ranks

AXES = ref_rs.AXES
RTOL, ATOL = 1e-5, 1e-6
HS_INC, HS_LOSS = 3e-2, 1e-4
V, D, B, L1, W, S, K = 40, 16, 8, 9, 3, 8, 5
LR, N_STEPS = 0.05, 2
WORLDS = (1, 2)
# the JAX cases at each world (one JAX compile each): SGNS capacities, HS
# heads and capacities; the epochs at world 2
SGNS_CASES = ((1, "normal"), (2, "normal"), (2, "overflow"))
HS_CASES = ((1, "head"), (2, "head"), (2, "no_head_overflow"))
EPOCH_WORLD = 2
EPOCH = dict(key=77, step0=5, lr0=0.05, lr_slope=0.001, min_lr=1e-4, n_batches=2)
W2V = dict(min_count=1, vector_size=32, max_iter=3, batch_walks=32, step_size=0.05)
STREAM_N2V = dict(num_walks=4, walk_length=8, walker_chunk=16)
# three chunks of 101 walks (padded to 102 over two ranks), dead steps among them
GEOMETRY_CHUNKS = np.random.default_rng(11).integers(-1, 34, (3, 101, 8)).astype(np.int32)
PIPE_N2V = {"num_walks": 4, "walk_length": 10}
QUALITY_N2V = dict(num_walks=6, walk_length=20)
QUALITY_W2V = dict(min_count=1, max_iter=3, vector_size=32)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_mesh(n: int) -> JaxMesh:
    return JaxMesh(np.array(jax.devices()[:n]).reshape(n, 1), AXES)


def _dump(tmp_path_factory, name, obj) -> str:
    path = str(tmp_path_factory.mktemp("row") / f"{name}.pkl")
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    return path


# --------------------------------------------------------------------------- #
# K18: the plan, in this process
# --------------------------------------------------------------------------- #

PLAN_R = 256  # one request length: JAX compiles _plan_routes once a (N, cap)
PLAN_CASES = {
    "repeats": (lambda rng: rng.integers(0, 40, PLAN_R), 64),
    "dead_zeros": (lambda rng: np.where(rng.random(PLAN_R) < 0.3, 0,
                                        rng.integers(0, 500, PLAN_R)), 64),
    "overflow": (lambda rng: rng.integers(0, 300, PLAN_R), 16),
}
PLAN_FIELDS = ("uniq", "inv", "is_uniq", "owner", "bucket_pos", "ok", "send_ids", "n_dropped")


@pytest.mark.parametrize("n_dev", (1, 2, 4))
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_routes_bit_equal_jax(case, n_dev):
    make, cap = PLAN_CASES[case]
    ids = make(np.random.default_rng(n_dev)).astype(np.int32)
    want = jax.jit(lambda i: ref_rs._plan_routes(i, n_dev, cap))(jnp.asarray(ids))
    for fn in (rs.plan_routes_plain, rs.plan_routes):  # CPU: the plain version
        got = fn(torch.from_numpy(ids), n_dev, cap)
        for field in PLAN_FIELDS:
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)), err_msg=field)
    # the port's fields: each request's returned row, the sorted order, n_uniq
    inv = got.inv.numpy()
    ok, owner, rank = got.ok.numpy(), got.owner.numpy(), got.bucket_pos.numpy()
    np.testing.assert_array_equal(got.slot.numpy(),
                                  np.where(ok[inv], owner[inv] * cap + rank[inv], -1))
    order = got.order.numpy()
    np.testing.assert_array_equal(order, np.argsort(ids, kind="stable"))
    assert int(got.n_uniq) == len(np.unique(ids)) == int(got.is_uniq.sum())
    if case == "overflow":
        assert int(want.n_dropped) > 0


# --------------------------------------------------------------------------- #
# the JAX side of the steps and epochs
# --------------------------------------------------------------------------- #


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    walks = rng.integers(0, V, (B, L1)).astype(np.int32)
    ends = rng.integers(2, L1 + 1, B)
    walks[np.arange(L1)[None, :] >= ends[:, None]] = -1
    walks[5] = -1
    mask = rng.random(V) > 0.15
    sgns = (rng.normal(0, 0.3, (V, D)).astype(np.float32),
            rng.normal(0, 0.3, (V, D)).astype(np.float32),
            rng.random(V).astype(np.float32), rng.random(V).astype(np.float32))
    alias, prob = build_alias_csr(np.array([0, V]), rng.random(V).astype(np.float32) + 0.1)
    tree = ref_build_huffman(rng.integers(1, 60, V))
    hs_tables = (_bf16(rng.normal(0, 0.3, (V, D))), _bf16(rng.normal(0, 0.3, (tree.n_inner, D))),
                 rng.random(V).astype(np.float32), rng.random(tree.n_inner).astype(np.float32))
    corpus = rng.integers(-1, V, (EPOCH["n_batches"] * B, L1)).astype(np.int32)
    return dict(walks=walks, mask=mask, sgns_tables=sgns, ns_alias=np.asarray(alias, np.int32),
                ns_prob=np.asarray(prob, np.float32), tree=tree, hs_tables=hs_tables,
                corpus=corpus)


def _sgns_draws(key, n, b_local):
    out = []
    for my in range(n):
        k1, k2, ksh = jax.random.split(jax.random.fold_in(key, my), 3)
        out.append((np.asarray(jax.random.randint(ksh, (b_local, L1), 1, W + 1), np.int32),
                    np.asarray(jax.random.uniform(k1, (S,))),
                    np.asarray(jax.random.uniform(k2, (S,)))))
    return out


def _hs_draws(key, n, b_local):
    return [np.asarray(jax.random.randint(jax.random.fold_in(key, my), (b_local, L1), 1, W + 1),
                       np.int32) for my in range(n)]


def _sharded(mesh, a):
    return jax.device_put(jnp.asarray(a), NamedSharding(mesh, P(AXES, None)))


def _jax_sgns_steps(inp, n, cap):
    mesh = _jax_mesh(n)
    state = ref_rs.row_state_from_host(mesh, *inp["sgns_tables"])
    step = functools.partial(ref_rs._row_sgns_step, n_dev=n, cap=cap, window=W, negatives=K,
                             shared_negatives=S, shrink_window=True, axis_name=AXES)
    fn = jax.jit(shard_map(step, mesh=mesh, in_specs=(P(AXES, None),) * 5 + (P(),) * 5,
                           out_specs=(P(AXES, None),) * 4 + (P(), P()), check_vma=False))
    tabs = tuple(state[:4])
    walks = _sharded(mesh, inp["walks"])
    noise = (jnp.asarray(inp["ns_alias"]), jnp.asarray(inp["ns_prob"]), jnp.asarray(inp["mask"]))
    losses, drops, draws = [], [], []
    for k in range(N_STEPS):
        key = jax.random.PRNGKey(100 + k)
        draws.append(_sgns_draws(key, n, B // n))
        *tabs, loss, d = fn(*tabs, walks, key, jnp.float32(LR), *noise)
        losses.append(float(loss))
        drops.append(int(d))
    host = ref_rs.row_state_to_host(ref_rs.RowShardedState(*tabs, V), n)
    return (list(host), losses, drops), draws


def _jax_hs_steps(inp, n, head, cap_in, cap_th):
    mesh = _jax_mesh(n)
    tree = inp["tree"]
    state = ref_rh.hs_state_from_host(mesh, *inp["hs_tables"])
    step = functools.partial(ref_rh._row_hs_step, n_dev=n, cap_in=cap_in, cap_th=cap_th,
                             window=W, shrink_window=True, axis_name=AXES, head_offsets=head)
    fn = jax.jit(shard_map(step, mesh=mesh, in_specs=(P(AXES, None),) * 5 + (P(),) * 6,
                           out_specs=(P(AXES, None),) * 4 + (P(), P()), check_vma=False))
    tabs = tuple(state[:4])
    walks = _sharded(mesh, inp["walks"])
    hs_tabs = tuple(jnp.asarray(a) for a in (tree.points, tree.codes, tree.lengths))
    losses, drops, draws = [], [], []
    for k in range(N_STEPS):
        key = jax.random.PRNGKey(200 + k)
        draws.append(_hs_draws(key, n, B // n))
        *tabs, loss, d = fn(*tabs, walks, key, jnp.float32(LR), *hs_tabs,
                            jnp.asarray(inp["mask"]))
        losses.append(float(loss))
        drops.append(int(d))
    host = ref_rh.hs_state_to_host(ref_rh.RowHSState(*tabs, V, tree.n_inner), n)
    return (list(host), losses, drops), draws


def _hs_cases(inp, n):
    """name -> (head_offsets, cap_in, cap_th) of world n: the head of levels
    0-2, and no head with capacities of 8 that drop rows."""
    tree = inp["tree"]
    head = head_level_offsets(tree, max_rows=7, table_rows=-(-tree.n_inner // n))
    cl = tree.points.shape[1]
    b_local = B // n
    caps = [rs.row_cap(b_local * L1, n), rs.row_cap(b_local * L1 * (cl - len(head) + 1), n)]
    every = {"head": (head, *caps), "no_head_overflow": ((0,), 8, 8)}
    return {name: every[name] for w, name in HS_CASES if w == n}


def _jax_epochs(inp, n):
    mesh = _jax_mesh(n)
    key = jax.random.PRNGKey(EPOCH["key"])
    b_local = B // n
    n_local = inp["corpus"].shape[0] // n
    perms = [np.asarray(jax.random.permutation(
        jax.random.fold_in(jax.random.fold_in(key, my), 0x5F5E1), n_local)) for my in range(n)]
    sgns_draws, hs_draws = [{} for _ in range(n)], [{} for _ in range(n)]
    for b in range(EPOCH["n_batches"]):
        gstep = EPOCH["step0"] + b
        kg = jax.random.fold_in(key, gstep)
        for my, (dr, hd) in enumerate(zip(_sgns_draws(kg, n, b_local), _hs_draws(kg, n, b_local))):
            sgns_draws[my][gstep], hs_draws[my][gstep] = dr, hd
    corpus = _sharded(mesh, inp["corpus"])
    common = dict(batch_local=b_local, n_batches=EPOCH["n_batches"], window=W,
                  shrink_window=True, min_lr=EPOCH["min_lr"])
    args = (key, EPOCH["step0"], EPOCH["lr0"], EPOCH["lr_slope"])
    state, losses, dropped = ref_rs.row_sgns_epoch(
        mesh, ref_rs.row_state_from_host(mesh, *inp["sgns_tables"]), corpus, *args,
        jnp.asarray(inp["ns_alias"]), jnp.asarray(inp["ns_prob"]), jnp.asarray(inp["mask"]),
        negatives=K, shared_negatives=S, **common)
    sgns = (list(ref_rs.row_state_to_host(state, n)), np.asarray(losses), int(dropped))
    tree = inp["tree"]
    head = head_level_offsets(tree, max_rows=7, table_rows=-(-tree.n_inner // n))
    state, losses, dropped = ref_rh.row_hs_epoch(
        mesh, ref_rh.hs_state_from_host(mesh, *inp["hs_tables"]), corpus, *args,
        *(jnp.asarray(a) for a in (tree.points, tree.codes, tree.lengths)),
        jnp.asarray(inp["mask"]), head_offsets=head, **common)
    hs_out = (list(ref_rh.hs_state_to_host(state, n)), np.asarray(losses), int(dropped))
    port = dict(perm=perms, sgns_draws=sgns_draws, hs_draws=hs_draws, head=head,
                step0=EPOCH["step0"], lr0=EPOCH["lr0"], lr_slope=EPOCH["lr_slope"],
                min_lr=EPOCH["min_lr"], n_batches=EPOCH["n_batches"], batch_local=b_local)
    return (sgns, hs_out), port


def _karate_walks():
    src, dst = torch_mesh_ranks.karate()
    g = from_edge_arrays(src, dst, directed=False)
    return random_walks(g, Node2VecParams(num_walks=6, walk_length=10), seed=0, device="cpu")


def _jax_checkpoints(tmp_path_factory, kwalks):
    """JAX's checkpoint files of a row-sharded state at 2 x 1 (random
    tables through ``row_state_from_host`` and back, JAX's own layout both
    ways): a train state at epoch 1, and the stream state that
    ``fit_streaming_sharded`` writes at the end of epoch 1 over its engine's
    chunks of karate (JAX's fingerprint, source token "karate" marked
    "|row-sharded", the walks' counts).  Returns (train dir, stream dir,
    n_chunks)."""
    mesh = _jax_mesh(2)
    rng = np.random.default_rng(9)
    tables = (rng.normal(0, 0.3, (34, 32)), rng.normal(0, 0.3, (34, 32)), rng.random(34),
              rng.random(34))
    host = ref_rs.row_state_to_host(ref_rs.row_state_from_host(mesh, *tables), 2)
    train = str(tmp_path_factory.mktemp("jax_ckpt"))
    ref_ck.save_train_state(train, 1, *host)
    src, dst = torch_mesh_ranks.karate()
    g = ref_from_edge_arrays(src, dst, directed=False)
    n_chunks, chunk, _ = RefWalkEngine(g, RefN2V(**STREAM_N2V), mesh=mesh).chunk_source(seed=0)
    params = RefW2V(**{**W2V, "max_iter": 1})
    stream = str(tmp_path_factory.mktemp("jax_stream"))
    ref_ck.save_stream_state(
        stream, ref_ck.stream_fingerprint(params, n_chunks, 34, token="karate|row-sharded"), 1,
        0, *host, epoch_losses=np.array([3.5], np.float32), cur_losses=np.zeros(0, np.float32),
        counts=np.bincount(kwalks[kwalks >= 0], minlength=34).astype(np.int64),
        chunk_walks=chunk + chunk % 2)
    return train, stream, n_chunks


def _jax_stream_geometry():
    """Every row epoch call of JAX's ``fit_streaming_sharded`` at 2 x 1 over
    GEOMETRY_CHUNKS, SGNS and HS, each epoch replaced by a recorder that
    trains nothing: (the interleaved chunk, step0, LR slope, batch_local,
    n_batches, key)."""
    out = {}
    for name, module, fn, kw in (("sgns", ref_rs, "row_sgns_epoch", {}),
                                 ("hs", ref_rh, "row_hs_epoch", {"negative": 0})):
        calls = out[name] = []

        def record(mesh, state, corpus, key, step0, lr0, lr_slope, *tables, batch_local,
                   n_batches, calls=calls, **_):
            calls.append((np.asarray(corpus), step0, lr_slope, batch_local, n_batches,
                          np.asarray(key)))
            return state, jnp.zeros((n_batches,), jnp.float32), 0

        model = Word2VecTPU(RefW2V(**{**W2V, "max_iter": 2, **kw}), shared_negatives=16)
        with mock.patch.object(module, fn, record):
            model.fit_streaming_sharded(lambda i: jnp.asarray(GEOMETRY_CHUNKS[i]),
                                        len(GEOMETRY_CHUNKS), _jax_mesh(2), 34)
    return out


def _jax_quality(g, labels) -> float:
    """micro-F1@0.5 of JAX's row trainer (``fit_sharded(table_sharding=
    "row")`` at 2 x 1, what its ``Node2Vec(mesh=, table_sharding="row")``
    trains on a one-chunk corpus) on walks of the quality graph ``g``."""
    walks = random_walks(g, Node2VecParams(**QUALITY_N2V), seed=0, device="cpu")
    model = Word2VecTPU(RefW2V(**QUALITY_W2V)).fit_sharded(
        walks, _jax_mesh(2), n_vertices=g.n_vertices, table_sharding="row")
    return multilabel_f1(np.asarray(model.vectors), labels, 0.5, 0)["micro_f1"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's checkpoint files, steps and epochs, and the ranks, each spawn
    running while this process computes the next JAX case: the pipeline at
    world 2 (which needs nothing of JAX) first, then the trainers at world
    2, then the steps and epochs at worlds 1 and 2."""
    pool = concurrent.futures.ThreadPoolExecutor(4)

    def spawn(n, name, case):
        path = _dump(tmp_path_factory, name, case)
        return pool.submit(launch.spawn, torch_row_ranks.programs, n, "gloo", "cpu",
                           [(name, path)], timeout=600)

    pipe = spawn(2, "pipeline", dict(n2v=PIPE_N2V, w2v={**W2V, "max_iter": 2}, quality_n=600,
                                     quality_n2v=QUALITY_N2V, quality_w2v=QUALITY_W2V))
    kwalks = _karate_walks()
    jax_ckpt, jax_stream, n_chunks = _jax_checkpoints(tmp_path_factory, kwalks)
    rng = np.random.default_rng(5)
    train_case = dict(walks=kwalks, w2v=W2V, n2v=STREAM_N2V, jax_ckpt=jax_ckpt,
                      jax_stream=jax_stream, port_ckpt=str(tmp_path_factory.mktemp("port")),
                      sub_corpus=rng.integers(-1, 30, (64, 9)).astype(np.int32),
                      keep=rng.random(30).astype(np.float32), stop_at_call=n_chunks + 4,
                      geometry_chunks=GEOMETRY_CHUNKS)
    train = spawn(2, "trainers", train_case)
    jax_geometry = _jax_stream_geometry()

    inp = _inputs()
    tree = inp["tree"]
    jax_out = {n: {"sgns": {}, "hs": {}} for n in WORLDS}
    case = dict(walks=inp["walks"], mask=inp["mask"], ns_alias=inp["ns_alias"],
                ns_prob=inp["ns_prob"], sgns_tables=inp["sgns_tables"],
                hs_tables=inp["hs_tables"], points=tree.points, codes=tree.codes,
                lengths=tree.lengths, corpus=inp["corpus"], window=W, negatives=K, shared=S,
                lr=LR, n_steps=N_STEPS, epoch={},
                sgns_caps={n: {} for n in WORLDS}, sgns_draws={n: {} for n in WORLDS},
                hs_cases={n: _hs_cases(inp, n) for n in WORLDS},
                hs_draws={n: {} for n in WORLDS})
    for n, name in SGNS_CASES:
        cap = rs.row_cap(B // n * L1 + S, n) if name == "normal" else 8
        case["sgns_caps"][n][name] = cap
        jax_out[n]["sgns"][name], case["sgns_draws"][n][name] = _jax_sgns_steps(inp, n, cap)
    for n, name in HS_CASES:
        jax_out[n]["hs"][name], case["hs_draws"][n][name] = _jax_hs_steps(
            inp, n, *case["hs_cases"][n][name])
    jax_out[EPOCH_WORLD]["epochs"], case["epoch"][EPOCH_WORLD] = _jax_epochs(inp, EPOCH_WORLD)
    steps = {n: spawn(n, "steps_and_epochs", case) for n in WORLDS}
    out = dict(jax=jax_out, ranks={n: [r[0] for r in f.result()] for n, f in steps.items()},
               trainers=[r[0] for r in train.result()],
               pipeline=[r[0] for r in pipe.result()], train_case=train_case,
               n_chunks=n_chunks, kwalks=kwalks, jax_geometry=jax_geometry)
    pool.shutdown()
    return out


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _close_increments(got, want, init, what):
    inc = np.asarray(want) - np.asarray(init)
    tol = HS_INC * max(float(np.abs(inc).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got) - np.asarray(init), inc, rtol=0, atol=tol,
                               err_msg=what)


NAMES = ("emb_in", "emb_out", "acc_in", "acc_out")


@pytest.mark.parametrize("n,cap", SGNS_CASES)
def test_row_sgns_step_matches_jax(runs, n, cap):
    want_state, want_losses, want_drops = runs["jax"][n]["sgns"][cap]
    for res in runs["ranks"][n]:
        state, losses, drops = res["sgns_step"][cap]
        for got, want, name in zip(state, want_state, NAMES):
            _close(got, want, name)
        _close(np.asarray(losses), np.asarray(want_losses), "losses")
        assert drops == [float(d) for d in want_drops]
    assert (sum(want_drops) > 0) == (cap == "overflow")


@pytest.mark.parametrize("n,case", HS_CASES, ids=lambda x: str(x))
def test_row_hs_step_matches_jax(runs, n, case):
    want_state, want_losses, want_drops = runs["jax"][n]["hs"][case]
    init = _inputs()["hs_tables"]
    for res in runs["ranks"][n]:
        state, losses, drops = res["hs_step"][case]
        for got, want, ini, name in zip(state, want_state, init, NAMES):
            _close_increments(got, want, ini, name)
        _close(np.asarray(losses), np.asarray(want_losses), "losses", rtol=HS_LOSS, atol=0)
        assert drops == [float(d) for d in want_drops]
    assert (sum(want_drops) > 0) == (case == "no_head_overflow")


def test_routed_steps_at_one_rank_equal_the_single_device_steps(runs):
    res = runs["ranks"][1][0]
    got, got_loss, want, want_loss = res["sgns_identity"]
    for g, w, name in zip(got, want, NAMES):
        _close(g, w, name)
    _close(got_loss, want_loss, "loss")
    for case, (got, got_loss, want, want_loss) in res["hs_identity"].items():
        for g, w, name in zip(got, want, NAMES):
            _close(g, w, f"{case} {name}")
        _close(got_loss, want_loss, f"{case} loss")


@pytest.mark.parametrize("objective", ("sgns", "hs"))
def test_row_epochs_match_jax(runs, objective):
    n = EPOCH_WORLD
    sgns, hs_out = runs["jax"][n]["epochs"]
    want_state, want_losses, want_dropped = sgns if objective == "sgns" else hs_out
    init = _inputs()[objective + "_tables"]
    for res in runs["ranks"][n]:
        state, losses, dropped = res[objective + "_epoch"]
        for got, want, ini, name in zip(state, want_state, init, NAMES):
            if objective == "sgns":
                _close(got, want, name)
            else:
                _close_increments(got, want, ini, name)
        _close(losses, want_losses, "losses", rtol=RTOL if objective == "sgns" else HS_LOSS,
               atol=ATOL if objective == "sgns" else 0)
        assert dropped == want_dropped == 0


# --------------------------------------------------------------------------- #
# the trainers at world 2
# --------------------------------------------------------------------------- #


def _trainers(runs):
    return runs["trainers"]


@pytest.mark.parametrize("objective", ("sgns", "hs"))
def test_fit_sharded_row_trains_and_keeps_replicas_equal(runs, objective):
    results = _trainers(runs)
    losses, vectors, emb_out = results[0]["fit_" + objective]
    assert len(losses) == W2V["max_iter"] and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    n_out = 34 if objective == "sgns" else 33  # HS: theta's n_inner rows
    assert vectors.shape == (34, 32) and emb_out.shape == (n_out, 32)
    assert np.isfinite(vectors).all() and np.isfinite(emb_out).all()
    for res in results[1:]:
        np.testing.assert_array_equal(res["fit_" + objective][1], vectors)
        np.testing.assert_array_equal(res["fit_" + objective][2], emb_out)
    sampled = results[0]["sampled"]
    assert len(sampled) == 2 and all(np.isfinite(sampled))


def test_k7_from_a_rank_position_equals_k7_on_the_whole_corpus(runs):
    """fit's contiguous rank blocks and the streaming chunk's stride
    interleave (word2vec.py:1245-1255) both draw what K7 draws on the
    whole (interleaved) corpus."""
    case = runs["train_case"]
    corpus = case["sub_corpus"]
    keep = torch.from_numpy(case["keep"])
    whole = subsample_walks_plain(torch.from_numpy(corpus), keep, 7, 3_000_001).numpy()
    n_c = corpus.shape[0]
    interleaved = corpus.reshape(n_c // 2, 2, -1).transpose(1, 0, 2).reshape(n_c, -1)
    whole_i = subsample_walks_plain(torch.from_numpy(interleaved.copy()), keep, 7,
                                    10_000_003).numpy()
    n_local = n_c // 2
    for rank, res in enumerate(_trainers(runs)):
        rows = slice(rank * n_local, (rank + 1) * n_local)
        np.testing.assert_array_equal(res["k7_block"], whole[rows])
        np.testing.assert_array_equal(res["interleaved"], interleaved[rows])
        np.testing.assert_array_equal(res["k7_interleaved"], whole_i[rows])
    assert (whole == -1).sum() > (corpus == -1).sum()


def test_row_checkpoints_cross_packages_both_ways(runs):
    case = runs["train_case"]
    saved = np.load(os.path.join(case["jax_ckpt"], "train_state.npz"))
    for res in _trainers(runs):
        for got, key in zip(res["resumed"], NAMES):
            np.testing.assert_array_equal(got, saved[key])
    port_dir, emb_in, emb_out = _trainers(runs)[0]["written"]
    ref = Word2VecTPU(RefW2V(**{**W2V, "max_iter": 1}), shared_negatives=16)
    ref.fit_sharded(runs["kwalks"], _jax_mesh(2), n_vertices=34, table_sharding="row",
                    checkpoint_dir=port_dir)
    np.testing.assert_array_equal(np.asarray(ref.emb_in), emb_in)
    np.testing.assert_array_equal(np.asarray(ref.emb_out), emb_out)


@pytest.mark.parametrize("objective", ("sgns", "hs"))
def test_fit_streaming_sharded_resumes_bit_equal(runs, objective):
    results = _trainers(runs)
    assert results[0]["n_chunks"] == runs["n_chunks"] >= 4
    first = results[0]["stream_" + objective]
    for res in results:
        losses, vec, out, losses2, vec2, out2, stopped = res["stream_" + objective]
        assert stopped and len(losses) == 2 and all(np.isfinite(losses))
        assert losses == losses2
        np.testing.assert_array_equal(vec, vec2)
        np.testing.assert_array_equal(out, out2)
        np.testing.assert_array_equal(vec, first[1])  # every rank: the full tables


@pytest.mark.parametrize("objective", ("sgns", "hs"))
def test_fit_streaming_sharded_chunk_loop_matches_jax(runs, objective):
    """The chunk loop against JAX's on the same chunks at 2 x 1, each row
    epoch replaced by a recorder in both: per call, in order, the rank's
    stride-interleaved rows (the chunk order and the padding), step0, the LR
    slope, batch_local, n_batches and the step key's number."""
    want = runs["jax_geometry"][objective]
    root = jax.random.PRNGKey(RefW2V().seed)
    assert len(want) == 2 * len(GEOMETRY_CHUNKS)
    for rank, res in enumerate(_trainers(runs)):
        got = res["geometry_" + objective]
        assert len(got) == len(want)
        for j, ((rows, step0, slope, batch_local, n_batches, key),
                (corpus, w_step0, w_slope, w_batch, w_n_batches, w_key)) in enumerate(
                    zip(got, want)):
            n_local = corpus.shape[0] // 2
            np.testing.assert_array_equal(rows, corpus[rank * n_local:(rank + 1) * n_local])
            assert (step0, batch_local, n_batches) == (w_step0, w_batch, w_n_batches)
            assert np.float32(slope) == np.float32(w_slope)
            assert key == 9_000_000 + j
            np.testing.assert_array_equal(w_key, jax.random.fold_in(root, 9_000_000 + j))


def test_jax_stream_state_resumes_in_the_port(runs):
    saved = np.load(os.path.join(runs["train_case"]["jax_stream"], "stream_state.npz"))
    for res in _trainers(runs):
        emb_in, emb_out = res["jax_stream"]
        np.testing.assert_array_equal(emb_in, saved["emb_in"])
        np.testing.assert_array_equal(emb_out, saved["emb_out"])


def test_row_trainers_keep_the_jax_guards(runs):
    guards = _trainers(runs)[0]["guards"]
    assert "requires table_sharding='row'" in guards["column"]
    assert "skip-gram only" in guards["cbow"] and "skip-gram only" in guards["cbow_fit"]


# --------------------------------------------------------------------------- #
# Node2Vec(mesh=, table_sharding="row")
# --------------------------------------------------------------------------- #


def _pipeline(runs):
    return runs["pipeline"]


@pytest.mark.parametrize("objective", ("sgns", "hs"))
def test_pipeline_row_walks_and_trains(runs, objective):
    """random_walk() + fit() (fit_sharded "row") and run_pipeline()
    (streaming over 3 chunks into fit_streaming_sharded) at 2 x 1: the walks
    equal JAX's, finite vectors the same on every rank."""
    src, dst = torch_mesh_ranks.karate()
    ref = node2vec_tpu.Node2Vec(n2v_params=PIPE_N2V, w2v_params=W2V, random_seed=3,
                                mesh=_jax_mesh(2), table_sharding="row")
    ref.preprocess_input_graph((src, dst), indexed=True, directed=False)
    want = ref.random_walk()
    results = _pipeline(runs)
    for res in results:
        walks, losses, vectors = res["fit_" + objective]
        np.testing.assert_array_equal(walks, want)
        assert len(losses) == 2 and all(np.isfinite(losses)) and np.isfinite(vectors).all()
        np.testing.assert_array_equal(vectors, results[0]["fit_" + objective][2])
        losses, vectors, walks = res["stream_" + objective]
        assert walks is None and len(losses) == 2 and all(np.isfinite(losses))
        np.testing.assert_array_equal(vectors, results[0]["stream_" + objective][1])


def test_pipeline_row_quality_close_to_jax(runs):
    """Node2Vec(mesh=, table_sharding="row") at 2 x 1 on the quality graph:
    micro-F1@0.5 within 0.05 of JAX's row trainer."""
    g, labels = synthetic_multilabel(600, seed=0)
    np.testing.assert_array_equal(node2vec_tpu.datasets.synthetic_multilabel(600, seed=0)[1],
                                  labels)
    want = _jax_quality(g, labels)
    got = multilabel_f1(_pipeline(runs)[0]["quality"], labels, 0.5, 0)["micro_f1"]
    assert got >= 0.55, got
    assert abs(got - want) <= 0.05, (got, want)
