"""node2vec_torch's shared-list 3-atom sampler and the wide shapes of the
walk-at-a-time step kernels against node2vec_tpu's on the CPU.

The slq tables, light rows (with the ebase lane), overflow fractions and
flags are bit-equal to the JAX package's, from the native core and from the
numpy fallback.  Weights in {0.5, 1, 2} and p, q powers of two make every
partial sum exact, so the plain walks with ``shared_lists=True`` are
bit-equal to JAX ``blocked_walk_chunk(..., shared_lists=True)``, in both
the exhaustive and the mixed form, on light and heavy rows.  General
weights are held by chi-square (p-value > 1e-4) through an edge whose list
overflows.  The wide cases run K2, K8, K9, K10 and K13's plain versions at
walk length 81 and dim 256 (K10: 512), where the kernels stage in global
memory, against the JAX steps at the tolerances of their own test files.
"""

import time
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import node2vec_tpu
from node2vec_tpu import native as ref_native
from node2vec_tpu.constants import Node2VecParams as RefParams
from node2vec_tpu.graph import from_edge_arrays as ref_from_edge_arrays
from node2vec_tpu.models import cbow as ref_cbow
from node2vec_tpu.models import hsoftmax as ref_hs
from node2vec_tpu.models import skipgram as ref_sg
from node2vec_tpu.ops.alias import build_alias_csr
from node2vec_tpu.walk import WalkEngine as RefWalkEngine
from node2vec_tpu.walk import blocked as ref_blocked
from node2vec_torch import Node2Vec, _build, convert, native
from node2vec_torch.constants import Node2VecParams
from node2vec_torch.datasets import synthetic_multilabel
from node2vec_torch.eval import walk_transition_pvalue
from node2vec_torch.graph import from_edge_arrays
from node2vec_torch.models import cbow
from node2vec_torch.models import hsoftmax as hs
from node2vec_torch.models import skipgram as sg
from node2vec_torch.walk import WalkEngine, blocked

DYADIC = np.float32([0.5, 1.0, 2.0])


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread each keeps parallel test workers from
    oversubscribing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _ref_native_loaded(deadline_s: float = 120.0) -> None:
    """Load the JAX package's native library, waiting out a concurrent
    build by another xdist worker (tests/test_torch_blocked.py:50)."""
    t_end = time.monotonic() + deadline_s
    while not ref_native.available():
        if time.monotonic() > t_end:
            pytest.fail(f"{ref_native._LIB_PATH} did not load within {deadline_s:.0f} s")
        time.sleep(0.5)
        ref_native._tried = False


# --------------------------------------------------------------------------- #
# graphs
# --------------------------------------------------------------------------- #


def _hub_edges(hub_deg=600, seed=0, weights=None):
    """tests/test_blocked.py:30's hub: vertex 0 with ``hub_deg`` out/in edges
    and a ring over its neighbours.  Every edge has at most 2 shared
    neighbours, so its lists are exhaustive; the hub is heavy at P = 31."""
    rng = np.random.default_rng(seed)
    nbrs = np.arange(1, hub_deg + 1, dtype=np.int32)
    src = np.concatenate([np.zeros(hub_deg, np.int32), nbrs, nbrs, nbrs % hub_deg + 1])
    dst = np.concatenate([nbrs, np.zeros(hub_deg, np.int32), nbrs % hub_deg + 1, nbrs])
    w = (rng.uniform(0.5, 2.0, len(src)).astype(np.float32) if weights is None
         else rng.choice(weights, len(src)))
    return src, dst, w


def _two_hub_edges(n_shared=20, n_spokes=300, weights=None):
    """tests/test_blocked.py:401's graph, undirected: hubs A = 0 and B = 1
    share ``n_shared`` neighbours, so the edge A -> B overflows SL_K while
    the hub -> shared-neighbour edges keep complete lists."""
    shared = np.arange(2, 2 + n_shared, dtype=np.int32)
    a_only = np.arange(2 + n_shared, 2 + n_shared + n_spokes, dtype=np.int32)
    b_only = a_only + n_spokes
    src = np.concatenate([np.zeros(1, np.int32), np.zeros(n_shared, np.int32), shared,
                          np.ones(n_shared, np.int32), np.zeros(n_spokes, np.int32),
                          np.ones(n_spokes, np.int32)])
    dst = np.concatenate([np.ones(1, np.int32), shared, np.full(n_shared, 1, np.int32),
                          shared, a_only, b_only])
    rng = np.random.default_rng(3)
    if weights is None:
        w = rng.uniform(0.5, 2.0, len(src)).astype(np.float32)
        w[0] = 60.0  # A - B: most first hops from A take the hub-hub edge
    else:
        w = rng.choice(weights, len(src))
        w[0] = 32.0
    return src, dst, w


def _dyadic_heavy(seed=0, n=500):
    """tests/test_torch_blocked.py's directed graph with weights {0.5, 1, 2}:
    three multi-block hubs (their edges overflow the lists: mixed form),
    light vertices of degree 1..40, reverse edges for half of the edges (so
    some return hops find no reverse edge) and sinks."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 41, n - 15)
    deg[:3] = (300, 520, 700)
    src = np.repeat(np.arange(n - 15), deg).astype(np.int32)
    dst = rng.integers(0, n, len(src)).astype(np.int32)
    back = rng.random(len(src)) < 0.5
    src, dst = np.concatenate([src, dst[back]]), np.concatenate([dst, src[back]])
    keep = src < n - 15
    return src[keep], dst[keep], rng.choice(DYADIC, int(keep.sum()))


GRAPHS = {
    "two_hub": lambda: (_two_hub_edges(), False),
    "directed": lambda: (_dyadic_heavy(), True),
}


# --------------------------------------------------------------------------- #
# tables
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_slq_tables_equal_jax(name, use_native):
    (src, dst, w), directed = GRAPHS[name]()
    g = from_edge_arrays(src, dst, w, directed=directed)
    if use_native:
        _ref_native_loaded()
    with mock.patch.object(native, "available", return_value=use_native), \
            mock.patch.object(ref_native, "available", return_value=use_native):
        want = ref_blocked.build_blocked_graph(g.indptr, g.indices, g.weights, shared_lists=True)
        got = blocked.build_blocked_graph(g.indptr, g.indices, g.weights, shared_lists=True,
                                          device="cpu")
        if use_native:  # the two packages' bindings
            np.testing.assert_array_equal(
                native.edge_shared_list(g.indptr, g.indices, g.weights),
                ref_native.edge_shared_list(g.indptr, g.indices, g.weights))
    for a, b in zip((*got[:4], got.slq), (*want[:4], want.slq)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (got.sl_ovf_wfrac, got.sl_exhaustive, got.shared_lists) == (
        want.sl_ovf_wfrac, want.sl_exhaustive, True)
    assert got.light.shape[1] == 128 and 0.0 < got.sl_ovf_wfrac < 1.0  # both overflow
    slq = got.slq.numpy().reshape(-1, blocked.SL_LANES)
    if directed:
        assert (slq[: g.n_edges, 12] == -1).any()  # edges with no reverse edge
    else:  # A -> B overflows, A -> a shared neighbour does not
        e_ab = int(g.indptr[0] + np.searchsorted(g.indices[g.indptr[0]: g.indptr[1]], 1))
        e_as = int(g.indptr[0] + np.searchsorted(g.indices[g.indptr[0]: g.indptr[1]], 2))
        assert slq[e_ab, 13] & 1 and not slq[e_as, 13] & 1


def test_numpy_fallback_equals_native_lists():
    """The port's numpy fallback and its native binding give the same slq
    rows (the JAX package's test holds the same for its own pair)."""
    src, dst, w = _dyadic_heavy(2, n=200)
    g = from_edge_arrays(src, dst, w, directed=True)
    with mock.patch.object(native, "available", return_value=False):
        fallback = blocked._edge_shared_list(g.indptr, g.indices, g.weights)
    np.testing.assert_array_equal(fallback, native.edge_shared_list(g.indptr, g.indices,
                                                                    g.weights))


@pytest.mark.parametrize("p_l", [31, 32])
def test_light_row_widths_and_ebase_equal_jax(p_l):
    """P = 31 keeps the ebase lane inside one 128-lane row; P = 32 takes 256
    lanes with it and 128 without, as the JAX package's layout."""
    for ebase in (False, True):
        assert blocked._light_row_width(p_l, ebase) == ref_blocked._light_row_width(p_l, ebase)
    src, dst, w = _hub_edges(60, weights=DYADIC)
    g = from_edge_arrays(src, dst, w, directed=True)
    for sl in (False, True):
        want = ref_blocked.build_blocked_graph(g.indptr, g.indices, g.weights, light_width=p_l,
                                               shared_lists=sl)
        got = blocked.build_blocked_graph(g.indptr, g.indices, g.weights, light_width=p_l,
                                          shared_lists=sl, device="cpu")
        np.testing.assert_array_equal(got.light.numpy(), np.asarray(want.light))
        assert got.light.shape[1] == (256 if (sl and p_l == 32) else 128)
        if sl:  # lane 4P holds each row's first global edge id
            np.testing.assert_array_equal(got.light[:, 4 * p_l].numpy(), g.indptr[:-1])
            assert got.sl_exhaustive == want.sl_exhaustive is True


# --------------------------------------------------------------------------- #
# walks
# --------------------------------------------------------------------------- #


def _walk_both(bg_ref, starts, gid_base, seed, shared_lists=True, **kw):
    bg = convert.blocked_graph_from_arrays(
        *(np.asarray(t) for t in bg_ref[:4]), bg_ref.light_width, bg_ref.block_width,
        bg_ref.has_heavy, device="cpu", slq=np.asarray(ref_blocked.slq_or_dummy(bg_ref)),
        sl_ovf_wfrac=bg_ref.sl_ovf_wfrac,
    )
    np.testing.assert_array_equal(blocked.slq_or_dummy(bg).numpy(),
                                  np.asarray(ref_blocked.slq_or_dummy(bg_ref)))
    shapes = dict(light_width=bg.light_width, block_width=bg.block_width,
                  has_heavy=bg.has_heavy, shared_lists=shared_lists,
                  sl_exhaustive=bg_ref.sl_exhaustive)
    want = ref_blocked.blocked_walk_chunk(
        *bg_ref[:4], ref_blocked.slq_or_dummy(bg_ref), jnp.asarray(starts),
        jnp.arange(gid_base, gid_base + len(starts), dtype=jnp.int32), jnp.uint32(seed),
        **shapes, **kw,
    )
    got = blocked.blocked_walk_chunk(*bg[:4], torch.from_numpy(starts), gid_base, seed,
                                     slq=bg.slq, **shapes, **kw)
    return [x.numpy() for x in got], [np.asarray(x) for x in want]


WALK_GRAPHS = {
    "exhaustive_hub": lambda: (_hub_edges(600, weights=DYADIC), True),
    "mixed_directed": lambda: (_dyadic_heavy(), True),
    "mixed_two_hub": lambda: (_two_hub_edges(weights=DYADIC), False),
}


@pytest.mark.parametrize("p,q,max_trials", [(0.25, 4.0, 64), (4.0, 0.25, 64), (0.25, 4.0, 2)])
@pytest.mark.parametrize("name", list(WALK_GRAPHS))
def test_plain_walks_bit_equal_jax(name, p, q, max_trials):
    (src, dst, w), directed = WALK_GRAPHS[name]()
    g = from_edge_arrays(src, dst, w, directed=directed)
    bg_ref = ref_blocked.build_blocked_graph(g.indptr, g.indices, g.weights, shared_lists=True)
    assert bg_ref.sl_exhaustive == name.startswith("exhaustive")
    assert bg_ref.has_heavy
    starts = (np.arange(1500) % g.n_vertices).astype(np.int32)
    starts[::17] = -1  # dead lanes
    (paths, n_fb, n_att), (w_paths, w_fb, w_att) = _walk_both(
        bg_ref, starts, 29, 0xC0FFEE, walk_length=12, return_param=p, inout_param=q,
        max_trials=max_trials,
    )
    np.testing.assert_array_equal(paths, w_paths)
    assert int(n_fb) == int(w_fb) and int(n_att) == int(w_att)
    assert (paths[::17] == -1).all()
    if max_trials == 2 and not bg_ref.sl_exhaustive:
        assert int(n_fb) > 0


def test_q1_with_a_table_equals_no_table():
    """At q == 1 the sampler is off: walks with the table are bit-equal to
    walks without it, in the port and in the JAX package."""
    src, dst, w = _dyadic_heavy(1)
    g = from_edge_arrays(src, dst, w, directed=True)
    bg_ref = ref_blocked.build_blocked_graph(g.indptr, g.indices, g.weights, shared_lists=True)
    starts = (np.arange(900) % g.n_vertices).astype(np.int32)
    kw = dict(walk_length=10, return_param=0.5, inout_param=1.0, max_trials=8)
    (on, *_), (ref_on, *_) = _walk_both(bg_ref, starts, 0, 3, shared_lists=True, **kw)
    (off, *_), _ = _walk_both(bg_ref, starts, 0, 3, shared_lists=False, **kw)
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(on, ref_on)


def test_overflow_edge_distribution_chi2():
    """A -> B overflows SL_K: transitions out of B with prev = A follow the
    analytic p/q law through the rejection-bound fallback, while the other
    lanes run the 3-atom sampler (tests/test_blocked.py:431)."""
    p, q = 0.25, 4.0
    g = from_edge_arrays(*_two_hub_edges(), directed=False)
    engine = WalkEngine(g, Node2VecParams(num_walks=16000, walk_length=2, return_param=p,
                                          inout_param=q, walker_chunk=1 << 15),
                        strategy="blocked", shared_lists=True, device="cpu")
    assert engine.bgraph.shared_lists and not engine.bgraph.sl_exhaustive
    assert engine._strategy_token() == "blocked+sl"
    walks = engine.run(seed=23, start_vertices=np.array([0], np.int32))
    assert (walks[:, 1] == 1).sum() > 1000  # ~13% of first hops take A -> B
    pval = walk_transition_pvalue(g, walks, 0, 1, p, q)
    assert pval is not None and pval > 1e-4, pval


def test_shared_lists_cut_attempts():
    """On the triangle-rich hub graph at q = 4 the 3-atom sampler needs
    fewer attempts a step than the rejection-bound sampler
    (tests/test_blocked.py:491), and both engines agree with JAX's counts."""
    src, dst, w = _hub_edges()
    g = from_edge_arrays(src, dst, w, directed=True)
    kw = dict(num_walks=8, walk_length=8, return_param=0.25, inout_param=4.0)
    e_on = WalkEngine(g, Node2VecParams(**kw), strategy="blocked", shared_lists=True,
                      device="cpu")
    e_off = WalkEngine(g, Node2VecParams(**kw), strategy="blocked", shared_lists=False,
                       device="cpu")
    assert e_on.bgraph.sl_exhaustive and e_on._strategy_token() == "blocked+slx"
    e_on.run(seed=2)
    e_off.run(seed=2)
    assert e_on.attempt_count < e_off.attempt_count, (e_on.attempt_count, e_off.attempt_count)


def test_shared_lists_chunk_invariance():
    g = from_edge_arrays(*_two_hub_edges(), directed=False)
    kw = dict(num_walks=3, walk_length=6, return_param=0.25, inout_param=4.0)
    w_small = WalkEngine(g, Node2VecParams(walker_chunk=128, **kw), strategy="blocked",
                         shared_lists=True, device="cpu").run(seed=5)
    w_big = WalkEngine(g, Node2VecParams(walker_chunk=1 << 15, **kw), strategy="blocked",
                       shared_lists=True, device="cpu").run(seed=5)
    np.testing.assert_array_equal(w_small, w_big)


def test_auto_policy_tokens_and_effective_chunk():
    """"auto" uses only a prebuilt table whose overflow weight fraction is
    <= 0.15; the walk-checkpoint token and the +144 words a walker follow the
    applied flags (tests/test_blocked.py:567), as in the JAX engine."""
    src, dst, w = _hub_edges(60)
    g = from_edge_arrays(src, dst, w, directed=True)
    g_ref = ref_from_edge_arrays(src, dst, w, directed=True)
    bg = blocked.build_blocked_graph(g.indptr, g.indices, g.weights, shared_lists=True,
                                     device="cpu")
    bg_ref = ref_blocked.build_blocked_graph(g.indptr, g.indices, g.weights, shared_lists=True)
    params = dict(num_walks=2, walk_length=20, walker_chunk=1 << 30, inout_param=2.0)
    big = 1 << 30
    for table, ref_table in ((bg, bg_ref), (bg._replace(sl_ovf_wfrac=0.5),
                                            bg_ref._replace(sl_ovf_wfrac=0.5))):
        for policy in ("auto", True, False):
            port = WalkEngine(g, Node2VecParams(**params), strategy="blocked",
                              blocked_graph=table, shared_lists=policy, device="cpu")
            ref = RefWalkEngine(g_ref, RefParams(**params), strategy="blocked",
                                blocked_graph=ref_table, shared_lists=policy)
            assert port._sl_flags() == ref._sl_flags()
            assert port._strategy_token() == ref._strategy_token()
            assert port._effective_chunk(big) == ref._effective_chunk(big)
    auto_high = WalkEngine(g, Node2VecParams(**params), strategy="blocked",
                           blocked_graph=bg._replace(sl_ovf_wfrac=0.5), device="cpu")
    on_high = WalkEngine(g, Node2VecParams(**params), strategy="blocked",
                         blocked_graph=bg._replace(sl_ovf_wfrac=0.5), shared_lists=True,
                         device="cpu")
    assert not auto_high._sl_flags()[0] and on_high._sl_flags() == (True, False)
    assert auto_high._effective_chunk(big) > on_high._effective_chunk(big)
    assert auto_high._strategy_token() == "blocked" and on_high._strategy_token() == "blocked+sl"
    # auto never builds a table; q == 1 drops the token
    assert WalkEngine(g, Node2VecParams(**params), strategy="blocked",
                      device="cpu").bgraph.slq is None
    q1 = WalkEngine(g, Node2VecParams(num_walks=2, walk_length=20), strategy="blocked",
                    shared_lists=True, device="cpu")
    assert q1.bgraph.shared_lists and q1._strategy_token() == "blocked"


def test_engine_run_equals_jax():
    src, dst, w = _dyadic_heavy(3)
    g = from_edge_arrays(src, dst, w, directed=True)
    g_ref = ref_from_edge_arrays(src, dst, w, directed=True)
    kw = dict(num_walks=3, walk_length=10, return_param=0.5, inout_param=2.0,
              max_rejection_trials=3, walker_chunk=300)
    ref = RefWalkEngine(g_ref, RefParams(**kw), strategy="blocked", shared_lists=True)
    port = WalkEngine(g, Node2VecParams(**kw), strategy="blocked", shared_lists=True,
                      device="cpu")
    np.testing.assert_array_equal(port.run(seed=8), ref.run(seed=8))
    assert port.fallback_count == ref.fallback_count
    assert port.attempt_count == ref.attempt_count
    np.testing.assert_array_equal(port.run_device(seed=4).numpy(), ref.run(seed=4))


def test_pipeline_shared_lists_walks_equal_jax():
    """Node2Vec(shared_lists=True) on a graph with hubs above degree 256
    takes the blocked engine with the lists in both packages; the walks of
    run_pipeline are bit-equal."""
    g, _ = synthetic_multilabel(600, avg_degree=12, n_labels=4, degree_skew=1.0, seed=0)
    src = np.repeat(np.arange(g.n_vertices), np.diff(g.indptr)).astype(np.int32)
    n2v = {"num_walks": 4, "walk_length": 12, "return_param": 0.5, "inout_param": 2.0}
    w2v = {"vector_size": 32, "max_iter": 1, "min_count": 1}
    ref = node2vec_tpu.Node2Vec(n2v_params=n2v, w2v_params=w2v, random_seed=1,
                                shared_lists=True)
    ref.preprocess_input_graph((src, g.indices), indexed=True, directed=True)
    ref.run_pipeline(streaming=False)
    port = Node2Vec(n2v_params=n2v, w2v_params=w2v, random_seed=1, shared_lists=True,
                    device="cpu")
    port.preprocess_input_graph((src, g.indices), indexed=True, directed=True)
    model = port.run_pipeline(streaming=False)
    engine = port._walk_engine()
    assert engine._strategy_token() == ref._walk_engine()._strategy_token()
    assert engine._strategy_token().startswith("blocked+sl")
    np.testing.assert_array_equal(port.walks, np.asarray(ref.walks))
    assert np.isfinite(model.vectors).all()


# --------------------------------------------------------------------------- #
# the step kernels' wide shapes (global staging on the card)
# --------------------------------------------------------------------------- #

WIDE_L1, WIDE_W, WIDE_S, WIDE_K, WIDE_B, WIDE_V = 81, 10, 64, 5, 3, 50
RTOL, ATOL = 1e-5, 1e-6
INC_TOL = 3e-2  # of an increment's max |.|: the JAX HS steps round to bf16
HS_LOSS_RTOL = {"hs_grads": 1e-5, "cbow_hs_grads": 1e-4}
# one compile each instead of one per primitive: faster on the CPU
_NS_STATIC = ("window", "negatives", "shared_negatives", "shrink_window", "packed")
_ref_sgns_step = jax.jit(ref_sg.sgns_walk_step_impl, static_argnames=_NS_STATIC)
_ref_pair_step = jax.jit(ref_sg.sgns_train_step_impl, static_argnames=_NS_STATIC[:-1])
_ref_cbow_step = jax.jit(ref_cbow.cbow_walk_step_impl,
                         static_argnames=_NS_STATIC + ("cbow_mean",))
_ref_hs_step = jax.jit(ref_hs.hs_walk_step_impl,
                       static_argnames=("window", "shrink_window", "head_offsets", "packed"))
_ref_cbow_hs_step = jax.jit(ref_cbow.cbow_hs_step_impl,
                            static_argnames=("window", "shrink_window", "cbow_mean", "packed"))


def _bf16_exact(x) -> np.ndarray:
    x = np.array(x, dtype=np.float32)
    x.view(np.uint32)[...] &= np.uint32(0xFFFF0000)
    return x


def _wide_inputs(dim: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    walks = rng.integers(0, WIDE_V, (WIDE_B, WIDE_L1)).astype(np.int32)
    walks[-1, 50:] = -1  # a walk that ends early
    walks[rng.random(walks.shape) < 0.05] = -1
    counts = rng.integers(0, 30, WIDE_V)
    mask = counts >= 3
    alias, prob = build_alias_csr(np.array([0, WIDE_V]),
                                  rng.random(WIDE_V).astype(np.float32) + 0.1)
    tree = hs.cap_code_length(hs.build_huffman(counts), counts)
    ns = [rng.normal(0, 0.3, (WIDE_V, dim)).astype(np.float32),
          rng.normal(0, 0.3, (WIDE_V, dim)).astype(np.float32),
          rng.random(WIDE_V).astype(np.float32), rng.random(WIDE_V).astype(np.float32)]
    hs_state = [_bf16_exact(rng.normal(0, 0.3, (WIDE_V, dim))),
                _bf16_exact(rng.normal(0, 0.3, (tree.n_inner, dim))),
                rng.random(WIDE_V).astype(np.float32),
                rng.random(tree.n_inner).astype(np.float32)]
    return walks, mask, alias, prob, tree, ns, hs_state


def _increments_close(got, want, init, names) -> None:
    for name, g, w, i in zip(names, got, want, init):
        inc, ref_inc = np.asarray(g) - i, np.asarray(w) - i
        scale = float(np.abs(ref_inc).max())
        assert scale > 0, f"{name}: no update"
        err = float(np.abs(inc - ref_inc).max())
        assert err <= INC_TOL * scale, f"{name}: increment error {err} > {INC_TOL} * {scale}"


@pytest.mark.parametrize("kernel", ["sgns_grads", "sgns_pair_grads", "cbow_grads",
                                    "hs_grads", "cbow_hs_grads"])
def test_wide_step_matches_jax(kernel):
    """Walk length 81, window 10, S = 64 at dim 256 (K10: 512): the shapes
    K2, K8, K9, K10 and K13 run in global staging mode."""
    dim = 512 if kernel == "cbow_hs_grads" else 256
    walks, mask, alias, prob, tree, ns, hs_state = _wide_inputs(dim)
    key = jax.random.PRNGKey(7)
    k_neg1, k_neg2, k_shrink = jax.random.split(key, 3)
    r1, r2 = (_t(jax.random.uniform(k, (WIDE_S,))) for k in (k_neg1, k_neg2))
    b_sh = _t(jax.random.randint(k_shrink, walks.shape, 1, WIDE_W + 1).astype(jnp.int32))
    lr, ref_lr = 0.05, jnp.float32(0.05)
    ns_kw = dict(window=WIDE_W, negatives=WIDE_K, shared_negatives=WIDE_S, shrink_window=True)
    if kernel in ("sgns_grads", "sgns_pair_grads", "cbow_grads"):
        ref_args = (*map(jnp.asarray, ns), jnp.asarray(walks), key, ref_lr, jnp.asarray(alias),
                    jnp.asarray(prob), jnp.asarray(mask))
        state = [_t(a) for a in ns]
        port_kw = dict(window=WIDE_W, negatives=WIDE_K)
        if kernel == "sgns_grads":
            want = _ref_sgns_step(*ref_args, **ns_kw)
            loss = sg.sgns_walk_step(*state, _t(walks), b_sh, r1, r2, lr, _t(alias), _t(prob),
                                     _t(mask), **port_kw)
        elif kernel == "sgns_pair_grads":
            want = _ref_pair_step(*ref_args, **ns_kw)
            b = _t(jax.random.randint(k_shrink, (WIDE_B, 1, WIDE_L1), 1,
                                      WIDE_W + 1).astype(jnp.int32))
            loss = sg.sgns_train_step(*state, _t(walks), b, r1, r2, lr, _t(alias), _t(prob),
                                      _t(mask), **port_kw)
        else:
            want = _ref_cbow_step(*ref_args, cbow_mean=True, **ns_kw)
            loss = cbow.cbow_walk_step(*state, _t(walks), b_sh, r1, r2, lr, _t(alias),
                                       _t(prob), _t(mask), cbow_mean=True, **port_kw)
        for name, a, w in zip(("emb_in", "emb_out", "acc_in", "acc_out", "loss"),
                              (*state, loss), want):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        return
    ref_args = (*map(jnp.asarray, hs_state), jnp.asarray(walks), key, ref_lr,
                jnp.asarray(tree.points), jnp.asarray(tree.codes), jnp.asarray(tree.lengths),
                jnp.asarray(mask))
    state = [_t(a) for a in hs_state]
    b_hs = _t(jax.random.randint(key, walks.shape, 1, WIDE_W + 1).astype(jnp.int32))
    tree_args = (_t(tree.points), _t(tree.codes), _t(tree.lengths), _t(mask))
    if kernel == "hs_grads":
        want = _ref_hs_step(*ref_args, window=WIDE_W, shrink_window=True, head_offsets=(0,))
        loss = hs.hs_walk_step(*state, _t(walks), b_hs, lr, *tree_args, window=WIDE_W,
                               head_offsets=(0,))
    else:
        want = _ref_cbow_hs_step(*ref_args, window=WIDE_W, shrink_window=True, cbow_mean=True)
        loss = cbow.cbow_hs_step(*state, _t(walks), b_hs, lr, *tree_args, window=WIDE_W,
                                 cbow_mean=True)
    np.testing.assert_allclose(float(loss), float(want[4]), rtol=HS_LOSS_RTOL[kernel])
    _increments_close([a.numpy() for a in state], want[:4], hs_state,
                      ("emb_in", "theta", "acc_in", "acc_theta"))


def test_staging_mode_choice(monkeypatch):
    """The wrapper stages in shared memory up to the card's opt-in limit and
    in a bounded global workspace above it (its stride matches
    csrc/staging.cuh's), chosen from the shape before any launch."""
    assert _build.staging_mode(232_448, 232_448) == "shared"
    assert _build.staging_mode(232_449, 232_448) == "global"
    assert [_build.staging_stride(n) for n in (1, 128, 129, 325_568)] == [32, 32, 64, 81_408]

    class Props:
        shared_memory_per_block_optin = 232_448
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Props)
    assert _build.staging(102_000, 2_560, "cpu") == (None, 0)
    ws, blocks = _build.staging(325_568, 2_560, "cpu")
    assert blocks == _build.STAGING_BLOCKS_PER_SM * 132
    assert ws.dtype == torch.float32 and ws.numel() == blocks * _build.staging_stride(325_568)
    ws, blocks = _build.staging(333_460, 3, "cpu")  # one block a walk
    assert blocks == 3 and ws.numel() == 3 * _build.staging_stride(333_460)
    # CPU tensors take the plain versions: no staging, no launch
    _build.reset_launches()
    walks, mask, alias, prob, tree, ns, _ = _wide_inputs(256)
    sg.sgns_grads(_t(ns[0]), _t(ns[1]), _t(walks), _t(mask), _t(np.ones_like(walks)),
                  _t(np.arange(WIDE_S, dtype=np.int32) % WIDE_V), window=WIDE_W,
                  negatives=WIDE_K)
    assert sum(_build.launches.values()) == 0
