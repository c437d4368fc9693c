"""Blocked-CSR walk engine for heavy-tailed graphs (port of
``node2vec_tpu/walk/blocked.py``).

The dense engine pads every vertex to the graph's max degree, which a graph
with hubs cannot afford.  This engine packs the CSR into two tables:

* ``light`` [V, 128] int32: a vertex of degree <= P (``light_width``, 31 by
  default) is one row of sorted ids | f32 weight bits | rev± | pfx.  A heavy
  vertex's row is a header instead: -2, first block, block count, total
  weight, degree, per-block minimum ids, per-block cumulative-mass CDF.
* ``biw`` [NB, 2C] int32: a heavy vertex's neighbours in blocks of C ids |
  weights; ``bids`` [NB, C] the same ids alone (membership probes); ``brp``
  [NB·C/64, 128] the per-slot (rev±, pfx) pairs.

``rev±`` is the f32 weight of the reverse edge with a triangle bit in the
sign, and ``pfx`` the CDF prefix of the source within the destination's row.
They ride along with every sampled edge, so the next step knows its 1/p
back-edge mass and excludes the return edge from the proposal exactly.

Walkers advance asynchronously: each attempt draws three uniforms keyed on
(seed, global walker id, attempt number), mixes the 1/p back atom with a
prev-excluded ∝w proposal (a two-level inverse CDF over the header and one
block), and accepts a non-return candidate with probability bias/alpha, the
bound alpha dropping to 1/q when the arrival edge closes no triangle.  A
walker that fails ``max_trials`` attempts in a row takes its ∝w proposal and
is counted (``n_fallback``).  Step 0 is first-order and sinks end a walk.

``shared_lists=True`` adds the exact 3-atom sampler.  ``build_blocked_graph``
lists each edge's shared neighbours (up to SL_K = 8 (slot, weight) pairs, 64 B an edge
in the ``slq`` table; light rows gain an ebase lane, the row's first global
edge id).  At q != 1 a lane whose arrival edge has a complete list draws
from three atoms: the back atom (w_back/p), the shared atom (their total
weight, picked by inverse CDF over the stored pairs, never rejected) and the
∝w atom ((wtot - w_back)/q), rejected only when its proposal lands on a
stored slot.  An edge with more shared neighbours overflows, and its lanes
keep the rejection-bound sampler; with no overflow at all
(``sl_exhaustive``) the membership probe against N(prev) drops out.  The
walker carries its arrival edge's global id: ebase[cur] + the accepted row
slot, or the stored reverse-edge id after a return hop.

``blocked_walk_chunk`` launches kernel K5 (``csrc/blocked_walk.cu``) for CUDA
tensors and runs ``blocked_walk_chunk_plain``, the JAX loop body op for op
in plain PyTorch, for CPU tensors.  The plain version runs the whole chunk
in one loop: the JAX package's tail-compaction cascade only regroups live
walkers and leaves every walk bit-identical.

``_edge_metadata_ranged`` computes the same per-edge metadata one vertex
range at a time (the range-exchange pass behind the graph-sharded engine's
``ranged_metadata=True``, ``parallel/edge_partitioned_blocked.py``), numpy
on the host as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from node2vec_torch import _build
from node2vec_torch.device import resolve_device
from node2vec_torch.ops.hashrng import hash_uniform
from node2vec_torch.ops.sampling import prefix_sums

PAD_ID = np.int32(np.iinfo(np.int32).max)  # sorts above any real id
SIGN = np.int32(-(1 << 31))  # triangle flag bit in rev_enc
MAG = np.int32(0x7FFFFFFF)
QUADS_PER_ROW = 64  # (rev, pfx) pairs per 128-lane brp row
KERNEL_MAX_P = 32  # K5 holds one light column per lane: 4P <= 128 data lanes
KERNEL_MAX_C = 2048
_PAD, _MAG = int(PAD_ID), int(MAG)  # as Python ints for torch expressions

# shared-list (slq) table: per edge 16 int32 lanes, 8 edges per 128-lane row
# (must match native/graph_core.cpp n2v_edge_shared_list):
#   [0:4]   up to K = 8 shared-neighbour positions within the sorted
#           destination row, 2 x uint16 per lane (0xFFFF pad)
#   [4:12]  f32 weight bits of those entries (0.0 pad)
#   [12]    global CSR index of the reverse edge (-1 absent)
#   [13]    flags: bit0 = overflow (more than K shared entries: the lane
#           falls back to the rejection-bound sampler)
SL_K = 8
SL_LANES = 16
SL_EDGES_PER_ROW = 8
SL_PAD_SLOT = 0xFFFF


def _max_blocks(light_width: int) -> int:
    """Heavy-header capacity: 5 scalars + mins[MAXB] + cum[MAXB] in 4P lanes."""
    return (4 * light_width - 5) // 2


def _light_row_width(light_width: int, ebase: bool = False) -> int:
    """Physical light-row lanes: 4P data lanes (+ 1 ebase lane when the
    shared-list sampler needs it) rounded up to 128.  The default P = 31
    makes 4P + 1 exactly 128; P = 32 with the ebase lane takes 256."""
    return -(-(4 * light_width + (1 if ebase else 0)) // 128) * 128


class BlockedGraph(NamedTuple):
    """Device tables of the blocked engine (see build_blocked_graph)."""

    light: torch.Tensor  # [V, RW] int32 light rows / heavy headers (+ ebase)
    biw: torch.Tensor  # [NB, 2C] int32 heavy blocks: ids | w bits
    bids: torch.Tensor  # [NB, C] int32 heavy block ids (membership probes)
    brp: torch.Tensor  # [NB*C/64, 128] int32 per-slot (rev_enc, pfx) pairs
    light_width: int  # P
    block_width: int  # C
    has_heavy: bool
    # per-edge shared-neighbour lists ([ceil(E/8), 128] int32, SL_* layout),
    # or None when the graph was built without them
    slq: Optional[torch.Tensor] = None
    # weight fraction of overflow edges (> SL_K shared entries): the engine's
    # auto policy uses the lists only when it is small
    sl_ovf_wfrac: float = 1.0

    @property
    def n_vertices(self) -> int:
        return self.light.shape[0]

    @property
    def shared_lists(self) -> bool:
        return self.slq is not None

    @property
    def sl_exhaustive(self) -> bool:
        """True when no edge overflowed: every q != 1 lane runs the 3-atom
        sampler, and the kernel skips the membership probe."""
        return self.slq is not None and self.sl_ovf_wfrac == 0.0


def _edge_has_shared(
    indptr: np.ndarray, indices: np.ndarray, deg: np.ndarray
) -> np.ndarray:
    """Per-edge triangle bit without the native core (which computes it
    inside ``edge_metadata``); conservative all-ones when the merge is too
    big (correct, just slower)."""
    n_e = len(indices)
    src_rep = np.repeat(np.arange(len(deg)), deg)
    merge_cost = np.minimum(deg[src_rep], deg[indices]).sum()
    if merge_cost > 5e7:
        return np.ones(n_e, dtype=bool)
    rows = [set(indices[indptr[v] : indptr[v + 1]].tolist()) for v in range(len(deg))]
    out = np.zeros(n_e, dtype=bool)
    for e in range(n_e):
        out[e] = bool(rows[src_rep[e]] & rows[indices[e]])
    return out


def _edge_metadata(
    indptr: np.ndarray, indices: np.ndarray, weights: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-edge reverse metadata over the whole graph: (rev_enc, pfx).

    rev_enc[e] = f32 bits of w(dst->src) (0 if absent) with the triangle bit
    in the sign; pfx[e] = weight-CDF prefix of src within N(dst).
    """
    from node2vec_torch import native

    if native.available():
        return native.edge_metadata(indptr, indices, weights)
    n_v = len(indptr) - 1
    n_e = len(indices)
    deg = np.diff(indptr)
    src_rep = np.repeat(np.arange(n_v, dtype=np.int64), deg)
    keys = src_rep * n_v + indices
    rkeys = indices.astype(np.int64) * n_v + src_rep
    pos = np.searchsorted(keys, rkeys)
    pos_c = np.minimum(pos, max(n_e - 1, 0))
    found = (pos < n_e) & (keys[pos_c] == rkeys) if n_e else np.zeros(0, bool)
    rev_w = np.where(found, weights[pos_c], np.float32(0.0)).astype(np.float32)
    cw = np.concatenate([[0.0], np.cumsum(weights, dtype=np.float64)])
    pfx = np.where(
        found, (cw[pos_c] - cw[indptr[indices]]).astype(np.float32), 0.0
    ).astype(np.float32)
    shared = _edge_has_shared(indptr, indices, deg)
    rev_enc = np.where(
        shared, rev_w.view(np.int32) | SIGN, rev_w.view(np.int32)
    ).astype(np.int32)
    return rev_enc, pfx.astype(np.float32)


def _concat_rows(
    indptr_local: np.ndarray, indices: np.ndarray, u_local: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """(lens, elems): concatenated CSR rows of ``u_local`` (local vertex
    indices) — vectorized variable-length gather, no per-row python loop."""
    lens = (indptr_local[u_local + 1] - indptr_local[u_local]).astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return lens, np.zeros(0, np.int64)
    starts = indptr_local[u_local].astype(np.int64)
    off = np.concatenate([[0], np.cumsum(lens)])
    idx = (
        np.repeat(starts, lens)
        + np.arange(total, dtype=np.int64)
        - np.repeat(off[:-1], lens)
    )
    return lens, indices[idx].astype(np.int64)


def _membership_encode(
    qu: np.ndarray,
    qv: np.ndarray,
    indptr_local: np.ndarray,
    indices_local: np.ndarray,
    lo: int,
) -> np.ndarray:
    """Encode membership queries for one peer as a flat int64 payload:
    ``[n_q, n_rows, n_elems | (u, v) pairs | (u, deg_u) pairs | N(u) ids]``.
    Each distinct querying vertex ships its (local, complete) row ONCE per
    peer; the per-peer traffic is sum(min-side degrees) + query pairs."""
    uu = np.unique(qu)
    lens, elems = _concat_rows(
        indptr_local, indices_local, (uu - lo).astype(np.int64)
    )
    parts = [np.array([len(qu), len(uu), len(elems)], np.int64)]
    if len(qu):
        parts.append(np.stack([qu, qv], axis=1).reshape(-1))
        parts.append(np.stack([uu, lens], axis=1).reshape(-1))
        parts.append(elems)
    return np.concatenate(parts).reshape(-1, 1)


def _membership_answer(
    flat: np.ndarray, keys_local: np.ndarray, n_vertices: int
) -> np.ndarray:
    """Answer one peer's membership payload against this range's sorted edge
    keys (``src * n_vertices + dst``): returns int64 [n_q, 3] rows
    ``(u, v, bit)`` where bit = 1 iff any shipped ``w ∈ N(u)`` satisfies
    ``(v -> w)`` locally — i.e. ``N(u) ∩ N(v) != ∅``, the exact reference
    triangle test (randomwalk.py:226 semantics over full rows)."""
    flat = np.asarray(flat, np.int64).reshape(-1)
    n_q, n_rows, n_el = int(flat[0]), int(flat[1]), int(flat[2])
    if n_q == 0:
        return np.zeros((0, 3), np.int64)
    qs = flat[3 : 3 + 2 * n_q].reshape(n_q, 2)
    rows = flat[3 + 2 * n_q : 3 + 2 * n_q + 2 * n_rows].reshape(n_rows, 2)
    elems = flat[3 + 2 * n_q + 2 * n_rows :]
    ru, rl = rows[:, 0], rows[:, 1]
    roff = np.concatenate([[0], np.cumsum(rl)])
    qi = np.searchsorted(ru, qs[:, 0])  # exact: sender ships every queried u
    rep = rl[qi]
    tot = int(rep.sum())
    qoff = np.concatenate([[0], np.cumsum(rep)])
    bits = np.zeros(n_q, np.int64)
    if tot and len(keys_local):
        pos = (
            np.repeat(roff[qi], rep)
            + np.arange(tot, dtype=np.int64)
            - np.repeat(qoff[:-1], rep)
        )
        w_el = elems[pos]
        v_rep = np.repeat(qs[:, 1], rep)
        tkeys = v_rep * n_vertices + w_el
        p = np.searchsorted(keys_local, tkeys)
        p_c = np.minimum(p, len(keys_local) - 1)
        hit = ((p < len(keys_local)) & (keys_local[p_c] == tkeys)).astype(
            np.int64
        )
        nz = rep > 0
        if nz.any():
            bits[nz] = np.maximum.reduceat(hit, qoff[:-1][nz])
    return np.stack([qs[:, 0], qs[:, 1], bits], axis=1)


def _propagate_dup_bits(keys: np.ndarray, upd: np.ndarray) -> np.ndarray:
    """OR each bit across runs of equal (sorted) keys — parallel edges of a
    directed multigraph share one (src, dst) key but searchsorted lands on
    the first copy only."""
    if len(keys) < 2:
        return upd
    dup = keys[1:] == keys[:-1]
    if not dup.any():
        return upd
    gid = np.cumsum(np.concatenate([[True], ~dup])) - 1
    gmax = np.zeros(int(gid[-1]) + 1, bool)
    np.logical_or.at(gmax, gid, upd)
    return gmax[gid]


def _edge_metadata_ranged(
    indptr: np.ndarray,
    indices: np.ndarray,
    weights: np.ndarray,
    n_ranges: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-edge (rev_enc, pfx) via RANGE-EXCHANGE passes — the multi-host
    metadata algorithm (ROADMAP item 5: distributed ``_edge_metadata``).

    The global pass needs the whole CSR resident to find each edge's reverse.
    This variant only ever holds one vertex-range's rows at a time plus the
    record traffic between two ranges — exactly the shape of a multi-host
    all-to-all over DCN:

    * producer pass: the owner of vertex ``v`` derives, for each of ITS edges
      ``(v -> u)``, the reverse metadata OF the mirrored edge ``(u -> v)``
      — ``rev_w = w(v->u)``, ``pfx`` = weight-CDF prefix of ``u`` within
      ``N(v)``, and ``deg(v)`` — from purely local rows, and emits a record
      keyed by ``owner(u)``;
    * consumer pass: the owner of ``u`` binary-searches each incoming
      ``(u, v)`` record into its sorted rows and writes the fields;
    * membership pass (round-4 VERDICT item 5 — previously conservative
      all-ones): for each edge ``(u -> v)`` whose endpoint degrees put it on
      the MIN side ((deg(u), u) < (deg(v), v); always when the reverse edge
      is absent), the owner of ``u`` ships ``N(u)`` once per peer plus the
      query pairs to ``owner(v)``, which tests ``N(u) ∩ N(v)`` against its
      sorted keys — total traffic sum(min(deg(u), deg(v))) like the
      single-host merge — and the answered bit is MIRRORED to the reverse
      edge in one more record round.  Triangle bits are therefore EXACT:
      graph-sharded biased walks pay 1/q (not max(1, 1/q)) on non-triangle
      arrivals, matching the monolithic engine's attempts/step.
    """
    n_v = len(indptr) - 1
    n_e = len(indices)
    rev_w = np.zeros(n_e, np.float32)
    pfx = np.zeros(n_e, np.float32)
    if n_e == 0 or n_v == 0:
        return rev_w.view(np.int32), pfx
    v_p = -(-n_v // n_ranges)
    big = np.int64(np.iinfo(np.int64).max)
    deg_dst = np.full(n_e, big, np.int64)  # deg(v) of edge (u->v); big = no rev
    has_bit = np.zeros(n_e, bool)

    def bounds_of(r):
        lo, hi = r * v_p, min((r + 1) * v_p, n_v)
        return lo, hi, int(indptr[lo]), int(indptr[hi])

    def local_keys(r):
        lo, hi, e_lo, e_hi = bounds_of(r)
        deg = np.diff(indptr[lo : hi + 1])
        src_rep = np.repeat(np.arange(lo, hi, dtype=np.int64), deg)
        return src_rep * n_v + indices[e_lo:e_hi]  # sorted (CSR row order)

    # producer pass: per range, records (u, v, rev_w, pfx, deg_v) -> owner(u)
    rec = [[] for _ in range(n_ranges)]
    for r in range(n_ranges):
        lo, hi, e_lo, e_hi = bounds_of(r)
        if e_hi == e_lo:
            continue
        deg = np.diff(indptr[lo : hi + 1])
        v_ids = np.repeat(np.arange(lo, hi, dtype=np.int64), deg)
        deg_v = np.repeat(deg.astype(np.int64), deg)
        u_ids = indices[e_lo:e_hi].astype(np.int64)
        w_loc = weights[e_lo:e_hi]
        cw = np.concatenate([[0.0], np.cumsum(w_loc, dtype=np.float64)])
        row_base = cw[np.repeat(indptr[lo:hi] - e_lo, deg)]
        pfx_loc = (cw[:-1] - row_base).astype(np.float32)
        payload = np.stack(
            [
                u_ids,
                v_ids,
                w_loc.view(np.int32).astype(np.int64),
                pfx_loc.view(np.int32).astype(np.int64),
                deg_v,
            ],
            axis=1,
        )
        owner = np.minimum(u_ids // v_p, n_ranges - 1)
        order = np.argsort(owner, kind="stable")
        bnd = np.searchsorted(owner[order], np.arange(n_ranges + 1))
        for t in range(n_ranges):
            if bnd[t + 1] > bnd[t]:
                rec[t].append(payload[order[bnd[t] : bnd[t + 1]]])

    # consumer pass: owner of u matches records to its sorted (u, v) edges
    for r in range(n_ranges):
        if not rec[r]:
            continue
        rr = np.concatenate(rec[r])
        lo, hi, e_lo, e_hi = bounds_of(r)
        keys = local_keys(r)
        rkeys = rr[:, 0] * n_v + rr[:, 1]
        pos = np.searchsorted(keys, rkeys)
        pos_c = np.minimum(pos, max(e_hi - e_lo - 1, 0))
        found = (pos < e_hi - e_lo) & (keys[pos_c] == rkeys)
        rev_w[e_lo + pos_c[found]] = (
            rr[found, 2].astype(np.int32).view(np.float32)
        )
        pfx[e_lo + pos_c[found]] = (
            rr[found, 3].astype(np.int32).view(np.float32)
        )
        deg_dst[e_lo + pos_c[found]] = rr[found, 4]

    # membership pass: min-side owners query owner(v) with N(u) shipped once
    # per peer; queries[r][t] = encoded payload from range r to range t
    queries = [[None] * n_ranges for _ in range(n_ranges)]
    for r in range(n_ranges):
        lo, hi, e_lo, e_hi = bounds_of(r)
        if e_hi == e_lo:
            continue
        deg = np.diff(indptr[lo : hi + 1]).astype(np.int64)
        u_ids = np.repeat(np.arange(lo, hi, dtype=np.int64), deg)
        v_ids = indices[e_lo:e_hi].astype(np.int64)
        d_u = np.repeat(deg, deg)
        d_v = deg_dst[e_lo:e_hi]
        selfe = u_ids == v_ids
        has_bit[e_lo:e_hi] |= selfe  # N(u) ∩ N(u) = N(u), nonempty (deg >= 1)
        min_side = (d_u < d_v) | ((d_u == d_v) & (u_ids < v_ids))
        qm = ~selfe & min_side
        q_owner = np.minimum(v_ids // v_p, n_ranges - 1)
        for t in range(n_ranges):
            sel = qm & (q_owner == t)
            queries[r][t] = _membership_encode(
                u_ids[sel], v_ids[sel],
                indptr[lo : hi + 1] - e_lo, indices[e_lo:e_hi], lo,
            )

    # answer pass + write-back + mirror records
    mirror = [[] for _ in range(n_ranges)]
    for t in range(n_ranges):
        keys_t = local_keys(t)
        for r in range(n_ranges):
            if queries[r][t] is None:
                continue
            ans = _membership_answer(queries[r][t], keys_t, n_v)
            if not len(ans):
                continue
            # write bits on the querying range's (u -> v) edges
            lo, hi, e_lo, e_hi = bounds_of(r)
            keys_r = local_keys(r)
            akeys = ans[:, 0] * n_v + ans[:, 1]
            pos = np.searchsorted(keys_r, akeys)  # exact: r owns these edges
            upd = np.zeros(e_hi - e_lo, bool)
            np.logical_or.at(upd, pos, ans[:, 2] != 0)
            has_bit[e_lo:e_hi] |= _propagate_dup_bits(keys_r, upd)
            # mirror to the reverse edge (v -> u) at owner(v)
            m_owner = np.minimum(ans[:, 1] // v_p, n_ranges - 1)
            order = np.argsort(m_owner, kind="stable")
            bnd = np.searchsorted(m_owner[order], np.arange(n_ranges + 1))
            for t2 in range(n_ranges):
                if bnd[t2 + 1] > bnd[t2]:
                    mirror[t2].append(ans[order[bnd[t2] : bnd[t2 + 1]]])

    for r in range(n_ranges):
        if not mirror[r]:
            continue
        mm = np.concatenate(mirror[r])
        lo, hi, e_lo, e_hi = bounds_of(r)
        keys = local_keys(r)
        mkeys = mm[:, 1] * n_v + mm[:, 0]  # reverse edge (v -> u)
        pos = np.searchsorted(keys, mkeys)
        pos_c = np.minimum(pos, max(e_hi - e_lo - 1, 0))
        found = (pos < e_hi - e_lo) & (keys[pos_c] == mkeys)
        upd = np.zeros(e_hi - e_lo, bool)
        np.logical_or.at(upd, pos_c[found], mm[found, 2] != 0)
        has_bit[e_lo:e_hi] |= _propagate_dup_bits(keys, upd)

    rev_bits = rev_w.view(np.int32)
    rev_enc = np.where(has_bit, rev_bits | SIGN, rev_bits).astype(np.int32)
    return rev_enc, pfx


def _pack_range(
    indptr: np.ndarray,
    indices: np.ndarray,
    weights: np.ndarray,
    rev_enc: np.ndarray,
    pfx: np.ndarray,
    lo: int,
    hi: int,
    p_l: int,
    c: int,
    ebase: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pack vertices [lo, hi) into (light, biw, bids, brp) host arrays.

    Heavy-header row layout ([4P] int32 lanes):
      [0] = -2 (heavy marker)  [1] block_start  [2] n_blocks
      [3] wtot (f32 bits)  [4] degree
      [5 : 5+MAXB]        per-block minimum neighbor id (PAD_ID padded)
      [5+MAXB : 5+2*MAXB] inclusive block-mass CDF (f32 bits; padded w/ wtot)
    ``ebase`` (shared-list builds): lane 4P of every row holds indptr[v].

    The threaded C++ packer when available; the numpy chain below otherwise.
    The two differ only in heavy-block CDF rounding (row-local double
    accumulation vs global-prefix difference: last f32 ulp, both exact).
    """
    from node2vec_torch import native

    if native.available():
        deg_r = np.diff(indptr[lo : hi + 1])
        nb_r = np.where(deg_r > p_l, -(-deg_r // c), 0)
        bs_r = np.concatenate([[0], np.cumsum(nb_r)])
        return native.pack_blocked(
            indptr, indices, weights, rev_enc, pfx, lo, hi, p_l, c,
            _light_row_width(p_l, ebase), bs_r[:-1], int(bs_r[-1]),
            ebase and indptr[hi] <= np.iinfo(np.int32).max,
        )
    maxb = _max_blocks(p_l)
    n_range = hi - lo
    e_lo, e_hi = int(indptr[lo]), int(indptr[hi])
    deg = np.diff(indptr[lo : hi + 1])
    heavy = deg > p_l
    n_heavy = int(heavy.sum())
    zero_bits = np.float32(0.0).view(np.int32)

    src_rep = np.repeat(np.arange(n_range, dtype=np.int64), deg)
    col = np.arange(e_lo, e_hi, dtype=np.int64) - np.repeat(indptr[lo:hi], deg)
    r_indices = indices[e_lo:e_hi]
    r_weights = weights[e_lo:e_hi]
    r_rev = rev_enc[e_lo:e_hi]
    r_pfx = pfx[e_lo:e_hi]

    light = np.empty((n_range, _light_row_width(p_l, ebase)), dtype=np.int32)
    light[:, :p_l] = PAD_ID
    light[:, p_l:] = zero_bits
    if ebase and indptr[hi] <= np.iinfo(np.int32).max:
        light[:, 4 * p_l] = indptr[lo:hi].astype(np.int32)
    e_light = np.repeat(~heavy, deg)
    lr = src_rep[e_light]
    lc = col[e_light]
    light[lr, lc] = r_indices[e_light]
    light[lr, p_l + lc] = r_weights[e_light].view(np.int32)
    light[lr, 2 * p_l + lc] = r_rev[e_light]
    light[lr, 3 * p_l + lc] = r_pfx[e_light].view(np.int32)

    hv = np.flatnonzero(heavy)
    nb = -(-deg[hv] // c) if n_heavy else np.zeros(0, np.int64)
    block_start = np.concatenate([[0], np.cumsum(nb)])
    n_blocks = max(int(block_start[-1]), 1)
    biw = np.empty((n_blocks, 2 * c), dtype=np.int32)
    biw[:, :c] = PAD_ID
    biw[:, c:] = zero_bits
    bids = np.full((n_blocks, c), PAD_ID, dtype=np.int32)
    brp = np.zeros((n_blocks * c // QUADS_PER_ROW, 128), dtype=np.int32)
    if n_heavy:
        rank = np.cumsum(heavy) - 1
        e_heavy = np.repeat(heavy, deg)
        hr = block_start[rank[src_rep[e_heavy]]] + col[e_heavy] // c
        hc = col[e_heavy] % c
        biw[hr, hc] = r_indices[e_heavy]
        biw[hr, c + hc] = r_weights[e_heavy].view(np.int32)
        bids[hr, hc] = r_indices[e_heavy]
        gslot = hr * c + hc
        brp[gslot // QUADS_PER_ROW, 2 * (gslot % QUADS_PER_ROW)] = r_rev[e_heavy]
        brp[gslot // QUADS_PER_ROW, 2 * (gslot % QUADS_PER_ROW) + 1] = r_pfx[
            e_heavy
        ].view(np.int32)

        cw = np.concatenate([[0.0], np.cumsum(r_weights, dtype=np.float64)])
        starts = indptr[lo:hi][hv] - e_lo
        ends = indptr[lo + 1 : hi + 1][hv] - e_lo
        bpos = np.minimum(
            starts[:, None] + np.arange(maxb + 1, dtype=np.int64) * c,
            ends[:, None],
        )
        cum = (cw[bpos[:, 1:]] - cw[starts, None]).astype(np.float32)
        light[hv, 0] = -2
        light[hv, 1] = block_start[:-1]
        light[hv, 2] = nb
        light[hv, 3] = cum[:, -1].view(np.int32)  # wtot == final CDF, exactly
        light[hv, 4] = deg[hv]
        valid = bpos[:, :maxb] < ends[:, None]
        mins = r_indices[np.minimum(bpos[:, :maxb], max(e_hi - e_lo - 1, 0))]
        light[hv[:, None], 5 + np.arange(maxb)[None, :]] = np.where(
            valid, mins, PAD_ID
        )
        light[hv[:, None], 5 + maxb + np.arange(maxb)[None, :]] = cum.view(np.int32)
    return light, biw, bids, brp


def _table_widths(indptr: np.ndarray, light_width: int | None,
                  block_width: int | None) -> Tuple[int, int]:
    """(P, C): P defaults to 31, C to the smallest power of two >= 256 that
    holds the max degree in MAXB blocks; the capacity is checked."""
    deg = np.diff(indptr)
    max_deg = int(deg.max()) if len(deg) else 0
    p_l = 31 if light_width is None else light_width
    if block_width is None:
        need = -(-max_deg // _max_blocks(p_l)) if (deg > p_l).any() else 1
        block_width = max(256, 1 << int(np.ceil(np.log2(max(need, 1)))))
    _check_capacity(max_deg, p_l, block_width)
    return p_l, block_width


def _check_capacity(max_deg: int, p_l: int, c: int) -> None:
    maxb = _max_blocks(p_l)
    if c % QUADS_PER_ROW:
        raise ValueError(f"block_width must be a multiple of {QUADS_PER_ROW}")
    if max_deg > maxb * c:
        raise ValueError(
            f"max degree {max_deg} exceeds the blocked engine's "
            f"{maxb}x{c} capacity; trim hotspots (max_out_degree) or raise "
            f"block_width/light_width"
        )


def _edge_shared_list(
    indptr: np.ndarray, indices: np.ndarray, weights: np.ndarray
) -> Optional[np.ndarray]:
    """Per-edge [E, SL_LANES] shared lists (SL_* layout): the native core's,
    or a per-edge loop for graphs of at most 200,000 edges; None otherwise."""
    from node2vec_torch import native

    if native.available():
        return native.edge_shared_list(indptr, indices, weights)
    n_e = len(indices)
    if n_e > 200_000:  # the per-edge loop below is too slow beyond
        return None
    n_v = len(indptr) - 1
    out = np.zeros((n_e, SL_LANES), dtype=np.int32)
    src_rep = np.repeat(np.arange(n_v), np.diff(indptr))
    rows = [indices[indptr[v] : indptr[v + 1]] for v in range(n_v)]
    sets = [set(r.tolist()) for r in rows]
    for e in range(n_e):
        u, v = int(src_rep[e]), int(indices[e])
        nv = rows[v]
        su = sets[u]
        slots = [j for j, x in enumerate(nv.tolist()) if x in su and x != u]
        ovf = len(slots) > SL_K or bool(slots and slots[-1] >= SL_PAD_SLOT)
        packed = np.full(SL_K, SL_PAD_SLOT, np.uint32)
        ws = np.zeros(SL_K, np.float32)
        if not ovf:
            packed[: len(slots)] = slots
            ws[: len(slots)] = weights[indptr[v] + np.asarray(slots, int)]
        out[e, : SL_K // 2] = (packed[0::2] | (packed[1::2] << np.uint32(16))).view(np.int32)
        out[e, SL_K // 2 : SL_K // 2 + SL_K] = ws.view(np.int32)
        pos = indptr[v] + np.searchsorted(nv, u)
        has_rev = pos < indptr[v + 1] and indices[pos] == u
        out[e, 12] = int(pos) if has_rev else -1
        out[e, 13] = 1 if ovf else 0
    return out


def build_blocked_graph(
    indptr: np.ndarray,
    indices: np.ndarray,
    weights: np.ndarray,
    light_width: int | None = None,
    block_width: int | None = None,
    shared_lists: bool = False,
    device="cuda",
) -> BlockedGraph:
    """Host-side packing of a sorted CSR graph into the blocked layout, the
    tables uploaded to ``device``.

    P defaults to 31 (4P + 1 rounds up to one 128-lane row, with the
    light/heavy split at degree 31); C to the smallest power of two >= 256
    that holds the max degree in MAXB blocks.

    ``shared_lists=True`` also builds the per-edge shared-neighbour lists of
    the exact 3-atom sampler (64 B an edge on the device and one native merge
    pass; off by default, as in the JAX package: on heavy-tailed graphs the
    hub-hub edges overflow the lists, and the per-step fetch costs more than
    the attempts it saves).
    """
    dev = resolve_device(device)
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int32)
    weights = np.asarray(weights, dtype=np.float32)
    n_v = len(indptr) - 1
    rev_enc, pfx = _edge_metadata(indptr, indices, weights)
    p_l, c = _table_widths(indptr, light_width, block_width)
    n_heavy = int((np.diff(indptr) > p_l).sum())

    tables = _pack_range(indptr, indices, weights, rev_enc, pfx, 0, n_v, p_l, c,
                         ebase=shared_lists)
    light, biw, bids, brp = (torch.from_numpy(a).to(dev) for a in tables)
    slq = None
    ovf_wfrac = 1.0
    if shared_lists:
        if len(indices) > np.iinfo(np.int32).max:
            raise ValueError(
                "shared_lists=True requires edge ids to fit int32 "
                f"(graph has {len(indices)} edges)"
            )
        sl = _edge_shared_list(indptr, indices, weights)
        if sl is None:
            raise ValueError(
                "shared_lists=True requires the native graph core "
                "(or a graph small enough for the numpy fallback)"
            )
        n_rows = -(-len(indices) // SL_EDGES_PER_ROW)
        slq_host = np.zeros((max(n_rows, 1), 128), dtype=np.int32)
        slq_host.reshape(-1)[: sl.size] = sl.reshape(-1)
        slq = torch.from_numpy(slq_host).to(dev)
        ovf = (sl[:, 13] & 1).astype(bool)
        if ovf.any():
            # clamped away from 0: sl_exhaustive means no edge overflowed, even
            # a zero-weight one
            wtot_all = float(weights.sum())
            frac = float(weights[ovf].sum()) / wtot_all if wtot_all > 0 else 1.0
            ovf_wfrac = max(frac, float(np.finfo(np.float32).tiny))
        else:
            ovf_wfrac = 0.0
    return BlockedGraph(light, biw, bids, brp, p_l, c, bool(n_heavy), slq, ovf_wfrac)


def slq_or_dummy(bg: BlockedGraph) -> torch.Tensor:
    """The slq operand for blocked_walk_chunk: the table, or a 1-row dummy
    for a graph built without shared lists."""
    if bg.slq is not None:
        return bg.slq
    return torch.zeros((1, 128), dtype=torch.int32, device=bg.light.device)


def _f32(bits: torch.Tensor) -> torch.Tensor:
    """int32 bits -> float32 values (a bitcast, as lax.bitcast_convert_type)."""
    return bits.contiguous().view(torch.float32)


def _pick(row: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """row[w, idx[w]]; idx is clamped into the row, and callers discard the
    lanes where it had to be (the JAX one-hot select gives 0 there)."""
    return row.gather(1, idx.clamp(0, row.shape[1] - 1)[:, None]).squeeze(1)


def blocked_walk_chunk_plain(
    light: torch.Tensor,
    biw: torch.Tensor,
    bids: torch.Tensor,
    brp: torch.Tensor,
    starts: torch.Tensor,
    gid_base: int,
    seed: int,
    *,
    walk_length: int,
    return_param: float,
    inout_param: float,
    max_trials: int,
    light_width: int,
    block_width: int,
    has_heavy: bool,
    slq: Optional[torch.Tensor] = None,
    shared_lists: bool = False,
    sl_exhaustive: bool = False,
    stats: dict | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX ``blocked_walk_chunk_impl`` op for op, its shared-list
    branch included (``slq``, ``shared_lists``, ``sl_exhaustive`` as there).

    ``stats``, when given, gains what the run reads, for a bound on the
    kernel's traffic: boolean masks of the distinct "light_rows" [V],
    "biw_rows" [NB] (a block's weights), "biw_id_sectors" (32 B sectors of
    biw holding a chosen id), "bids_rows" [NB] (membership probes of a heavy
    prev) and "brp_sectors" (32 B sectors of brp holding a chosen (rev, pfx)
    pair); and the per-access counts "heavy_attempts" (attempts at a heavy
    vertex), "heavy_prev_probes" and "slq_fetches" (64 B list entries read).
    """
    p_l, c = light_width, block_width
    maxb = _max_blocks(p_l)
    dev = starts.device
    n_w = starts.shape[0]
    el = walk_length
    seed = seed & 0xFFFFFFFF
    f32 = torch.float32
    inv_p = torch.tensor(np.float32(1.0 / return_param), device=dev)
    inv_q = torch.tensor(np.float32(1.0 / inout_param), device=dev)
    alpha_sh = torch.tensor(np.float32(max(1.0, 1.0 / inout_param)), device=dev)
    one = torch.tensor(1.0, dtype=f32, device=dev)
    zero = torch.tensor(0.0, dtype=f32, device=dev)
    uniform_bias = return_param == 1.0 and inout_param == 1.0
    need_membership = inout_param != 1.0
    use_sl = shared_lists and need_membership
    # exhaustive lists: no lane falls back, so N(prev) is never consulted
    sl_total = use_sl and sl_exhaustive
    need_mem_rows = need_membership and not sl_total
    prev_keep = max(p_l, 5 + maxb)
    gids = torch.arange(gid_base, gid_base + n_w, dtype=torch.int64, device=dev)
    lanes = torch.arange(n_w, device=dev)

    alive = starts >= 0
    paths = torch.full((n_w, el + 1), -1, dtype=torch.int32, device=dev)
    paths[:, 0] = torch.where(alive, starts, -1)
    t = torch.zeros(n_w, dtype=torch.int64, device=dev)
    cur = torch.where(alive, starts, 0)
    prev = torch.full((n_w,), -1, dtype=torch.int32, device=dev)
    w_fwd = torch.zeros(n_w, dtype=f32, device=dev)
    fwd_pfx = torch.zeros_like(w_fwd)
    w_back = torch.zeros_like(w_fwd)
    back_pfx = torch.zeros_like(w_fwd)
    back_shared = torch.zeros(n_w, dtype=torch.bool, device=dev)
    cur_row = torch.full((n_w, light.shape[1]), _PAD, dtype=torch.int32, device=dev)
    prev_mem = torch.full((n_w, prev_keep), _PAD, dtype=torch.int32, device=dev)
    trials = torch.zeros(n_w, dtype=torch.int64, device=dev)
    need_entry = torch.ones(n_w, dtype=torch.bool, device=dev)
    n_fb = torch.zeros((), dtype=torch.int64, device=dev)
    att = torch.zeros(n_w, dtype=torch.int64, device=dev)
    if use_sl:
        slq_edges = slq.reshape(-1, SL_LANES)  # row e: edge e's list
        aedge = torch.full((n_w,), -1, dtype=torch.int64, device=dev)  # arrival edge id
        sl_row = torch.zeros((n_w, SL_LANES), dtype=torch.int32, device=dev)
    if stats is not None:
        stats.setdefault("slq_fetches", 0)
        for key, n in (("light_rows", light.shape[0]), ("biw_rows", biw.shape[0]),
                       ("biw_id_sectors", biw.numel() // 8), ("bids_rows", bids.shape[0]),
                       ("brp_sectors", brp.numel() // 8)):
            stats.setdefault(key, torch.zeros(n, dtype=torch.bool, device=dev))

    it_bound = el * (max_trials + 2)
    it = 0
    while it < it_bound and bool(alive.any()):
        it += 1
        # --- entry: (re)gather the frontier vertex's row -------------------
        entry = need_entry & alive
        if stats is not None:
            stats["light_rows"][cur[entry].long()] = True
        lr = light[torch.where(entry, cur, 0).long()]
        cur_row = torch.where(entry[:, None], lr, cur_row)
        if use_sl:
            # one list entry per accepted step: the arrival edge's
            fetch = entry & (aedge >= 0)
            if stats is not None:
                stats["slq_fetches"] += int(fetch.sum())
            sl_row = torch.where(fetch[:, None], slq_edges[torch.where(fetch, aedge, 0)], sl_row)
            ebase_cur = cur_row[:, 4 * p_l].long()
            # decode: K slots (2 x uint16 a lane, 0xFFFF pad) and K f32 weights
            packed = sl_row[:, : SL_K // 2]
            slot_k = torch.stack([packed & 0xFFFF, (packed >> 16) & 0xFFFF], dim=2).reshape(
                n_w, SL_K)
            valid_k = slot_k != SL_PAD_SLOT
            w_k = _f32(sl_row[:, SL_K // 2 : SL_K // 2 + SL_K])
            w_sh = w_k.sum(1)
            sl_valid = (aedge >= 0) & ((sl_row[:, 13] & 1) == 0)
        ids = cur_row[:, :p_l]
        w_light = _f32(cur_row[:, p_l : 2 * p_l])
        if has_heavy:
            is_heavy = cur_row[:, 0] < -1
            h_bs = cur_row[:, 1].long()
            h_nb = cur_row[:, 2].long()
            h_cum = _f32(cur_row[:, 5 + maxb : 5 + 2 * maxb])
            degree = torch.where(
                is_heavy, cur_row[:, 4].long(), ((ids != _PAD) & (ids >= 0)).sum(1)
            )
            wtot = torch.where(is_heavy, _f32(cur_row[:, 3]), w_light.sum(1))
        else:
            is_heavy = torch.zeros(n_w, dtype=torch.bool, device=dev)
            degree = (ids != _PAD).sum(1)
            wtot = w_light.sum(1)
        alive = alive & ~(entry & (degree == 0))  # sink death
        attempted = alive

        first_order = t == 0
        ctr = att * 4
        u_branch = hash_uniform(seed, gids, ctr)
        u_prop = hash_uniform(seed, gids, ctr + 1)
        u_acc = hash_uniform(seed, gids, ctr + 2)

        # --- mixture: back-edge atom vs prev-excluded ∝w -------------------
        if uniform_bias:
            take_back = torch.zeros(n_w, dtype=torch.bool, device=dev)
            target = u_prop * wtot
        else:
            alpha2 = torch.where(back_shared, alpha_sh, inv_q)
            m1 = w_back * inv_p  # w_back == 0 at step 0
            rest = torch.clamp(wtot - w_back, min=0.0)
            if use_sl:
                # the exact 3-atom mixture on lanes with a complete list: the
                # shared mass is an atom of its own, so the ∝w atom needs no
                # bias headroom
                alpha2 = torch.where(sl_valid, inv_q, alpha2)
                msh = torch.where(sl_valid, w_sh, zero)
                m2 = rest * alpha2
                ub = u_branch * (m1 + msh + m2)
                take_back = ub < m1
                take_sh = sl_valid & ~take_back & (ub < m1 + msh)
                # the shared atom's pick: inverse CDF over the stored weights
                cdf_sh = prefix_sums(w_k)
                n_sh = valid_k.sum(1)
                k_idx = torch.minimum((cdf_sh < (u_prop * w_sh)[:, None]).sum(1),
                                      torch.clamp(n_sh - 1, min=0))
                sh_slot = _pick(slot_k, k_idx).long()
            else:
                m2 = rest * alpha2
                take_back = u_branch < m1 / torch.clamp(m1 + m2, min=1e-30)
            u2 = u_prop * rest  # u2 in [0, wtot - w_back) skips prev's interval
            target = torch.where(u2 < back_pfx, u2, u2 + w_back)

        # --- proposal: two-level exact inverse CDF -------------------------
        cdf_l = prefix_sums(w_light)
        slot_l = (cdf_l < target[:, None]).sum(1)
        slot_l = torch.minimum(slot_l, torch.clamp(degree - 1, min=0))
        if use_sl:  # a shared-atom pick overrides the ∝w slot
            slot_l = torch.where(take_sh, sh_slot, slot_l)
        cand_l = _pick(ids, slot_l)
        w_l = _pick(w_light, slot_l)
        ppfx_l = torch.where(slot_l > 0, _pick(cdf_l, slot_l - 1), zero)
        if not uniform_bias:
            rev_l = _pick(cur_row[:, 2 * p_l : 3 * p_l], slot_l)
            pfx_l = _f32(_pick(cur_row[:, 3 * p_l : 4 * p_l], slot_l))

        if has_heavy:
            blk = (h_cum < target[:, None]).sum(1)
            blk = torch.minimum(blk, torch.clamp(h_nb - 1, min=0))
            if use_sl:  # forced before the block's gather: its block is fetched
                blk = torch.where(take_sh, sh_slot // c, blk)
            base = torch.where(blk > 0, _pick(h_cum, blk - 1), zero)
            resid = target - base
            brow = biw[torch.where(alive & is_heavy, h_bs + blk, 0)]
            bw = _f32(brow[:, c:])
            nvalid = (brow[:, :c] != _PAD).sum(1)
            cdf_b = prefix_sums(bw)
            slot_b = (cdf_b < resid[:, None]).sum(1)
            slot_b = torch.minimum(slot_b, torch.clamp(nvalid - 1, min=0))
            if use_sl:
                slot_b = torch.where(take_sh, sh_slot % c, slot_b)
            if stats is not None:
                hv = alive & is_heavy
                stats["biw_rows"][(h_bs + blk)[hv]] = True
                stats["biw_id_sectors"][((h_bs + blk) * 2 * c + slot_b)[hv] // 8] = True
            cand_h = _pick(brow[:, :c], slot_b)
            w_h = _pick(bw, slot_b)
            ppfx_h = base + torch.where(slot_b > 0, _pick(cdf_b, slot_b - 1), zero)
            cand = torch.where(is_heavy, cand_h, cand_l)
            w_cand = torch.where(is_heavy, w_h, w_l)
            ppfx_cand = torch.where(is_heavy, ppfx_h, ppfx_l)
            if not uniform_bias:
                gslot = (h_bs + blk) * c + slot_b
                if stats is not None:
                    stats["brp_sectors"][gslot[alive & is_heavy] // 4] = True  # 8 B pairs
                qrow = brp[torch.where(alive & is_heavy, gslot // QUADS_PER_ROW, 0)]
                qpos = 2 * (gslot % QUADS_PER_ROW)
                rev_h = _pick(qrow, qpos)
                pfx_h = _f32(_pick(qrow, qpos + 1))
                rev_enc_c = torch.where(is_heavy, rev_h, rev_l)
                pfx_c = torch.where(is_heavy, pfx_h, pfx_l)
        else:
            cand, w_cand, ppfx_cand = cand_l, w_l, ppfx_l
            if not uniform_bias:
                rev_enc_c, pfx_c = rev_l, pfx_l

        # --- acceptance ----------------------------------------------------
        if use_sl:
            # the accepted slot within N(cur), and whether the ∝w proposal
            # landed on a stored shared slot (it belongs to the shared atom)
            row_slot = torch.where(is_heavy, blk * c + slot_b, slot_l) if has_heavy else slot_l
            hit = (valid_k & (slot_k == row_slot[:, None])).any(1)
        if uniform_bias:
            accept = torch.ones(n_w, dtype=torch.bool, device=dev)
        elif not need_membership:
            # q == 1: every non-return bias is 1 and prev is excluded
            accept = take_back | first_order | (cand != prev)
        elif sl_total:
            accept = first_order | take_back | take_sh | ((cand != prev) & ~hit)
        else:
            shared = (prev_mem[:, :p_l] == cand[:, None]).any(1)
            if has_heavy:
                prev_is_heavy = prev_mem[:, 0] < -1
                p_bs = prev_mem[:, 1].long()
                p_nb = prev_mem[:, 2].long()
                mins = prev_mem[:, 5 : 5 + maxb]
                jm = (mins <= cand[:, None]).sum(1) - 1
                jm = torch.minimum(torch.clamp(jm, min=0), torch.clamp(p_nb - 1, min=0))
                mrow = bids[torch.where(alive & prev_is_heavy, p_bs + jm, 0)]
                shared_heavy = (mrow == cand[:, None]).any(1)
                shared = torch.where(prev_is_heavy, shared_heavy, shared)
            bias2 = torch.where(shared, one, inv_q)
            accept = take_back | first_order | ((cand != prev) & (u_acc * alpha2 <= bias2))
            if use_sl:
                # list lanes are exact without a coin or N(prev)
                accept_sl = take_back | take_sh | ((cand != prev) & ~hit)
                accept = torch.where(sl_valid, accept_sl, accept)
            if stats is not None and has_heavy:
                probes = alive & prev_is_heavy & ~(take_back | first_order) & (cand != prev)
                if use_sl:  # the kernel probes only for lanes without a list
                    probes = probes & ~sl_valid
                stats["bids_rows"][(p_bs + jm)[probes]] = True
                stats["heavy_prev_probes"] = stats.get("heavy_prev_probes", 0) + int(probes.sum())
        if stats is not None:
            stats["heavy_attempts"] = stats.get("heavy_attempts", 0) + int((alive & is_heavy).sum())

        # --- trial cap: bounded-bias ∝weight fallback, counted -------------
        trials = torch.where(accept, 0, trials + 1)
        force = alive & (trials >= max_trials)
        n_fb = n_fb + (force & ~accept).sum()
        accept = accept | force

        # --- advance accepted lanes ----------------------------------------
        adv = alive & accept
        take = take_back & ~force
        nxt = torch.where(take, prev, cand)
        paths[lanes[adv], t[adv] + 1] = nxt[adv]
        if not uniform_bias:
            # arrival-edge metadata for the next step; a return hop traverses
            # the known (cur->prev) edge, so its fields are swaps of carries
            nw_fwd = torch.where(take, w_back, w_cand)
            nf_pfx = torch.where(take, back_pfx, ppfx_cand)
            nw_back = torch.where(take, w_fwd, _f32(rev_enc_c & _MAG))
            nb_pfx = torch.where(take, fwd_pfx, pfx_c)
            nb_shared = torch.where(take, back_shared, rev_enc_c < 0)
            w_fwd = torch.where(adv, nw_fwd, w_fwd)
            fwd_pfx = torch.where(adv, nf_pfx, fwd_pfx)
            w_back = torch.where(adv, nw_back, w_back)
            back_pfx = torch.where(adv, nb_pfx, back_pfx)
            back_shared = torch.where(adv, nb_shared, back_shared)
        if need_mem_rows:
            prev_mem = torch.where(adv[:, None], cur_row[:, :prev_keep], prev_mem)
        if use_sl:
            # a return hop traverses the arrival edge's stored reverse edge;
            # any other hop the edge ebase[cur] + its slot
            new_ae = torch.where(take, sl_row[:, 12].long(), ebase_cur + row_slot)
            aedge = torch.where(adv, new_ae, aedge)
        prev = torch.where(adv, cur, prev)
        cur = torch.where(adv, nxt, cur)
        t = torch.where(adv, t + 1, t)
        trials = torch.where(adv, 0, trials)
        need_entry = adv
        alive = alive & (t < el)
        # every lane that drew counts, including one whose final accepted
        # attempt just finished its walk
        att = torch.where(attempted, att + 1, att)
    return paths, n_fb, att.sum()


def blocked_walk_chunk(
    light: torch.Tensor,  # [V, 128 or 256] int32 light rows / heavy headers
    biw: torch.Tensor,  # [NB, 2C] int32
    bids: torch.Tensor,  # [NB, C] int32
    brp: torch.Tensor,  # [NB*C/64, 128] int32
    starts: torch.Tensor,  # [W] int32, negative = dead lane
    gid_base: int,  # global id of lane 0 (chunk-invariant RNG)
    seed: int,
    *,
    walk_length: int,
    return_param: float,
    inout_param: float,
    max_trials: int,
    light_width: int,
    block_width: int,
    has_heavy: bool,
    slq: Optional[torch.Tensor] = None,  # [*, 128] int32 shared lists
    shared_lists: bool = False,
    sl_exhaustive: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Async blocked walks: (paths [W, L+1] int32, n_fallback, n_attempts),
    the two counts as int64 scalars on the tables' device.

    ``shared_lists=True`` (with ``build_blocked_graph``'s ``slq`` table and a light row
    carrying the ebase lane) runs the 3-atom sampler at q != 1;
    ``sl_exhaustive`` says no edge overflowed.  At q == 1 both are ignored,
    and walks are bit-identical with or without the table.

    CPU tensors take the plain version; CUDA tensors launch K5 or raise.
    """
    tables = (light, biw, bids, brp, starts)
    if any(x.dtype != torch.int32 for x in tables):
        raise TypeError("blocked_walk_chunk takes int32 tables and starts")
    p_l, c = light_width, block_width
    if (
        light.dim() != 2 or light.shape[1] < 4 * p_l
        or biw.dim() != 2 or biw.shape[1] != 2 * c
        or bids.shape != (biw.shape[0], c)
        or brp.shape != (biw.shape[0] * c // QUADS_PER_ROW, 128)
        or starts.dim() != 1 or c % QUADS_PER_ROW
    ):
        raise ValueError(
            "blocked_walk_chunk takes light [V, >=4P], biw [NB, 2C], bids [NB, C], "
            "brp [NB*C/64, 128] and starts [W], C a multiple of 64"
        )
    if max_trials < 1:
        raise ValueError(f"max_trials must be >= 1, got {max_trials}")
    use_sl = bool(shared_lists) and inout_param != 1.0
    if use_sl and (slq is None or slq.dtype != torch.int32 or slq.dim() != 2
                   or slq.shape[1] != 128 or light.shape[1] < 4 * p_l + 1):
        raise ValueError("shared_lists=True takes an int32 slq [*, 128] and light rows "
                         "with the ebase lane (build_blocked_graph(shared_lists=True))")
    kw = dict(walk_length=walk_length, return_param=return_param,
              inout_param=inout_param, max_trials=max_trials,
              light_width=p_l, block_width=c, has_heavy=has_heavy)
    if not light.is_cuda:
        return blocked_walk_chunk_plain(light, biw, bids, brp, starts, gid_base, seed, slq=slq,
                                        shared_lists=use_sl, sl_exhaustive=sl_exhaustive, **kw)
    if p_l > KERNEL_MAX_P or light.shape[1] not in (128, 256):
        raise ValueError(f"blocked_walk kernel takes light_width <= {KERNEL_MAX_P} "
                         "(rows of 128 or 256 lanes)")
    if c > KERNEL_MAX_C:
        raise ValueError(f"blocked_walk kernel takes block_width <= {KERNEL_MAX_C}")
    _build.require_cuda("blocked_walk", *tables, *((slq,) if use_sl else ()))
    n_w = starts.shape[0]
    paths = torch.empty((n_w, walk_length + 1), dtype=torch.int32, device=starts.device)
    counters = torch.zeros(2, dtype=torch.int64, device=starts.device)
    if use_sl:
        mode = 4 if sl_exhaustive else 3  # the 3-atom sampler; 3 keeps N(prev) probes
    elif inout_param != 1.0:
        mode = 2  # membership against N(prev)
    elif return_param != 1.0:
        mode = 1  # q == 1: only the return edge is biased
    else:
        mode = 0  # uniform bias: every proposal is accepted
    rc = _build.lib().n2v_blocked_walk(
        _build.ptr(light), light.shape[1], _build.ptr(biw), _build.ptr(bids), _build.ptr(brp),
        _build.ptr_or_null(slq if use_sl else None), _build.ptr(starts), _build.ptr(paths),
        _build.ptr(counters),
        n_w, walk_length, int(gid_base), seed & 0xFFFFFFFF,
        float(np.float32(1.0 / return_param)), float(np.float32(1.0 / inout_param)),
        float(np.float32(max(1.0, 1.0 / inout_param))),
        max_trials, p_l, c, int(bool(has_heavy)), mode, _build.stream_of(starts),
    )
    _build.check(rc, "blocked_walk")
    _build.launches["blocked_walk"] += 1
    if use_sl:
        _build.launches["blocked_walk_sl_exhaustive" if mode == 4 else "blocked_walk_sl_mixed"] += 1
    return paths, counters[0], counters[1]
