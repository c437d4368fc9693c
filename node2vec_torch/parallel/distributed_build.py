"""Distributed (per-participant) host-side graph build (port of
``node2vec_tpu/parallel/distributed_build.py``).

The monolithic build (``graph/ingest.py::build_graph`` +
``parallel/edge_partitioned_blocked.py::partition_blocked_graph``) needs one
host to hold the whole edge list.  Here every build stage runs per process
on a shard of the edge list, with bulk-synchronous range exchanges in place
of the reference's distributed shuffles (Spark's ``zipWithIndex`` indexing
and ``repartition`` by source, ``spark.py:496-534``).

A build *participant* is a Python generator.  All communication between
participants is ``recv = yield send``: ``send[j]`` is an int64 ``[n_j, W]``
payload for peer j, and ``recv[j]`` the payload peer j sent this one.  Two
drivers run participants:

* ``run_local``: in lockstep in one process (tests, one host);
* ``run_distributed``: one participant a rank; each exchange is an
  all-gather of the row counts and one padded all_to_all of int64 tensors
  over the mesh (``build_mesh1d``: every rank of the world on one axis), so
  no host holds more than its own shard and one round's buckets.

Stages (each bit-equal to the monolithic build):

1. **Indexing** (``indexed=False``; integer or string names): splitter
   ranges from a merged sample, sort-unique per range, a prefix sum of the
   range sizes for the global id base: sorted-unique global ids, the host
   indexer's.  Endpoint lookups are routed queries answered by binary
   search.  String names travel as fixed-width UTF-8 bytes in int64 lanes.
2. **Undirected mirroring**, local; duplicates are dropped after routing,
   keyed on the global concatenation index, so the kept copy is
   ``mirror_dedup``'s first occurrence.
3. **Routing**: edges go to the participant owning their source's range.
4. **Hotspot trim**: per-vertex streams keyed on the global vertex id (the
   native core), in global-index order, so the kept subset is the same
   whichever host trims.
5. **Per-edge reverse metadata**: the producer/consumer range exchange of
   ``walk/blocked.py::_edge_metadata_ranged`` across processes (reverse
   weights, CDF prefixes), and the triangle bits from a membership exchange
   (each edge's min-degree side ships its row once a peer, with the query
   pairs; the far owner tests ``N(u) ∩ N(v)`` and the bit is mirrored to the
   reverse edge).
6. **Packing**: each participant packs its own vertex ranges in the blocked
   layout (``_pack_range``) and keeps those shards.

Nothing here runs on the card: the build is host work, whatever device the
walks then use.  ``assemble_partitioned`` puts a participant's shards on a
device as a ``PartitionedBlockedGraph``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from node2vec_torch import native
from node2vec_torch.constants import MAX_OUT_DEGREES
from node2vec_torch.walk.blocked import (
    PAD_ID,
    QUADS_PER_ROW,
    _check_capacity,
    _max_blocks,
    _membership_answer,
    _membership_encode,
    _pack_range,
    _propagate_dup_bits,
)

__all__ = [
    "build_participant",
    "run_local",
    "run_distributed",
    "build_mesh1d",
    "assemble_partitioned",
    "DistributedBuildResult",
]

_SIGN = np.int64(np.uint32(0x80000000))  # has_shared bit (conservative)


class DistributedBuildResult:
    """One participant's share of the built graph.

    ``light/biw/bids/brp`` are this participant's vertex ranges packed in the
    blocked layout (stacked range-major, padded to the global
    blocks-per-shard); ``names``/``name_base`` its slice of the global
    sorted-unique name table (None when the input was pre-indexed);
    ``indptr/indices/weights`` its local CSR rows (LOCAL edge offsets,
    global vertex ids); ``meta`` mirrors ``save_partitioned_graph``'s
    meta.json fields.
    """

    def __init__(self, pid, ranges, light, biw, bids, brp, indptr, indices,
                 weights, rev_enc, pfx, names, name_base, meta):
        self.pid = pid
        self.ranges = ranges
        self.light = light
        self.biw = biw
        self.bids = bids
        self.brp = brp
        self.indptr = indptr
        self.indices = indices
        self.weights = weights
        self.rev_enc = rev_enc
        self.pfx = pfx
        self.names = names
        self.name_base = name_base
        self.meta = meta


def _route(values: np.ndarray, owner: np.ndarray, nparts: int):
    """Split rows of ``values`` by ``owner``; returns (blocks, order) where
    ``order`` restores the original row positions from the routed layout."""
    order = np.argsort(owner, kind="stable")
    bounds = np.searchsorted(owner[order], np.arange(nparts + 1))
    blocks = [values[order[bounds[j]:bounds[j + 1]]] for j in range(nparts)]
    return blocks, order, bounds


def _names_to_payload(a: np.ndarray, width: int) -> np.ndarray:
    """Fixed-width byte names (``S{width}``, width % 8 == 0) as an int64
    [n, width/8] exchange payload (raw byte reinterpret — comparisons only
    ever happen on the S form, where numpy's byte order IS the UTF-8
    lexicographic order, which equals code-point order)."""
    n = len(a)
    if n == 0:
        return np.zeros((0, width // 8), np.int64)
    raw = np.frombuffer(
        np.ascontiguousarray(a).tobytes(), np.uint8
    ).reshape(n, a.dtype.itemsize)
    if a.dtype.itemsize < width:
        raw = np.concatenate(
            [raw, np.zeros((n, width - a.dtype.itemsize), np.uint8)], axis=1
        )
    return np.ascontiguousarray(raw).view(np.int64)


def _payload_to_names(p: np.ndarray, width: int) -> np.ndarray:
    """Inverse of _names_to_payload."""
    p = np.ascontiguousarray(np.asarray(p, np.int64))
    if len(p) == 0:
        return np.zeros(0, f"S{width}")
    return np.frombuffer(p.view(np.uint8).tobytes(), dtype=f"S{width}")


def build_participant(
    pid: int,
    nparts: int,
    src: np.ndarray,
    dst: np.ndarray,
    weight: Optional[np.ndarray] = None,
    *,
    n_shards: Optional[int] = None,
    indexed: bool = True,
    directed: bool = True,
    max_out_degree: int = 0,
    random_seed: Optional[int] = None,
    log1p_weight: bool = False,
    light_width: Optional[int] = None,
    block_width: Optional[int] = None,
):
    """Generator: one participant of an ``nparts``-way distributed build.

    ``src/dst`` is THIS participant's contiguous shard of the global edge
    list (shards concatenate in pid order to the monolithic input);
    ``weight`` defaults to 1.0 (reference ``spark.py:490-491``).
    ``n_shards`` is the number of packed vertex ranges (default ``nparts``);
    it must be a multiple of ``nparts`` — participant p owns ranges
    ``[p * n_shards/nparts, (p+1) * n_shards/nparts)``.

    Protocol: ``recv = yield send`` with int64 ``[n, W]`` payload blocks,
    one per peer.  Drive with ``run_local`` or ``run_distributed``.
    """
    if not native.available():
        raise RuntimeError(
            "the distributed build requires the native graph core (its "
            "per-vertex trim streams are what make trimming "
            "partition-deterministic)"
        )
    n_shards = nparts if n_shards is None else n_shards
    if n_shards % nparts:
        raise ValueError(f"n_shards={n_shards} must be a multiple of nparts={nparts}")
    rpp = n_shards // nparts  # ranges per participant
    if max_out_degree <= 0:
        max_out_degree = MAX_OUT_DEGREES
    seed_val = 0 if random_seed is None else int(random_seed)

    src = np.asarray(src)
    dst = np.asarray(dst)
    is_str = src.dtype.kind in ("U", "S", "O") or dst.dtype.kind in (
        "U", "S", "O"
    )
    if is_str:
        if indexed:
            raise ValueError("indexed=True requires integer vertex ids")
        # UTF-8 byte order == code-point order, so the fixed-width byte
        # pipeline below reproduces the host indexer's np.unique id order
        # bit-for-bit (NUL bytes inside names are unsupported — numpy's S
        # comparisons stop at trailing NULs)
        src_b = np.char.encode(src.astype("U"), "utf-8")
        dst_b = np.char.encode(dst.astype("U"), "utf-8")
    elif np.issubdtype(src.dtype, np.integer) and np.issubdtype(
        dst.dtype, np.integer
    ):
        src = src.astype(np.int64)
        dst = dst.astype(np.int64)
    else:
        raise NotImplementedError(
            "distributed indexing supports integer or string vertex names"
        )
    n_local = len(src)
    w = (
        np.ones(n_local, dtype=np.float32)
        if weight is None
        else np.asarray(weight, dtype=np.float32).copy()
    )
    if log1p_weight:
        w = np.log1p(w)
    if np.any(w < 0):
        raise ValueError("negative edge weights are not supported")

    # ---- sizes: global edge-count offsets (for global concat indices) ----
    cnt = np.array([[n_local]], np.int64)
    recv = yield [cnt] * nparts
    sizes = np.array([int(r[0, 0]) for r in recv], np.int64)
    e_offset = int(sizes[:pid].sum())
    e_total = int(sizes.sum())

    names = None
    name_base = 0
    if indexed:
        if n_local and (src.min() < 0 or dst.min() < 0):
            raise ValueError("indexed vertex ids must be non-negative")
        # global n_vertices = max id + 1 across shards
        local_max = int(max(src.max(initial=-1), dst.max(initial=-1)))
        recv = yield [np.array([[local_max]], np.int64)] * nparts
        n_vertices = max(int(r[0, 0]) for r in recv) + 1
        if n_vertices >= 2**31:
            raise ValueError("indexed vertex ids must fit int32 (< 2^31)")
    else:
        # ---- stage 1: distributed sorted-unique indexing ----
        # Name-kind generic: integer names exchange as int64 scalars; string
        # names agree on a global fixed byte width first and exchange as
        # raw-byte int64 lanes — all comparisons happen
        # on numpy S arrays, whose byte order reproduces np.unique's
        # code-point order, so the resulting ids bit-match the host-global
        # indexer (graph/indexer.py factorize path).
        if is_str:
            wloc = max(src_b.dtype.itemsize, dst_b.dtype.itemsize, 1)
            recv = yield [np.array([[wloc]], np.int64)] * nparts
            width = -(-max(int(r[0, 0]) for r in recv) // 8) * 8
            sdt = f"S{width}"
            src_n = src_b.astype(sdt)
            dst_n = dst_b.astype(sdt)

            def enc(a):
                return _names_to_payload(np.asarray(a, sdt), width)

            def dec(p):
                return _payload_to_names(p, width)

        else:
            src_n, dst_n = src, dst

            def enc(a):
                return np.asarray(a, np.int64).reshape(-1, 1)

            def dec(p):
                return np.asarray(p, np.int64).reshape(-1)

        lu = (
            np.unique(np.concatenate([src_n, dst_n]))
            if n_local
            else dec(enc([]))
        )
        # sample-based splitters (deterministic: every participant derives
        # them from the same merged sample multiset)
        n_samp = min(len(lu), 64)
        samp = lu[np.linspace(0, len(lu) - 1, n_samp).astype(np.int64)] if n_samp else lu
        recv = yield [enc(samp)] * nparts
        merged = np.sort(np.concatenate([dec(r) for r in recv]))
        if len(merged) == 0:
            splitters = merged[:0] if is_str else np.zeros(nparts - 1, np.int64)
        else:
            qs = (np.arange(1, nparts) * len(merged)) // nparts
            splitters = merged[np.minimum(qs, len(merged) - 1)]

        def owner_of_name(x):
            return np.searchsorted(splitters, x, side="right").astype(np.int64)

        blocks, _, _ = _route(enc(lu), owner_of_name(lu), nparts)
        recv = yield blocks
        my_names = np.unique(np.concatenate([dec(r) for r in recv]))
        recv = yield [np.array([[len(my_names)]], np.int64)] * nparts
        name_counts = np.array([int(r[0, 0]) for r in recv], np.int64)
        name_base = int(name_counts[:pid].sum())
        n_vertices = int(name_counts.sum())
        if n_vertices >= 2**31:
            raise ValueError(f"Too many vertices for int32 ids: {n_vertices}")
        # this participant's slice of the global name table (strings decode
        # back to the host indexer's unicode dtype)
        names = (
            np.char.decode(my_names, "utf-8") if is_str else my_names
        )

        # endpoint lookups: route queries to name owners, answers ride the
        # mirrored exchange back (bucket j of the reply aligns with what we
        # sent j — the exchange is an involution on bucket layout)
        queries = np.concatenate([src_n, dst_n])
        q_owner = owner_of_name(queries)
        q_blocks, q_order, _ = _route(enc(queries), q_owner, nparts)
        recv = yield q_blocks
        answers = []
        for r in recv:
            q = dec(r)
            pos = np.searchsorted(my_names, q)
            pos_c = np.minimum(pos, max(len(my_names) - 1, 0))
            ok = (pos < len(my_names)) & (
                my_names[pos_c] == q if len(my_names) else False
            )
            if not np.all(ok):
                raise AssertionError("distributed index lookup missed a name")
            answers.append((name_base + pos_c).reshape(-1, 1))
        recv = yield answers
        flat = np.concatenate([r.reshape(-1) for r in recv]) if len(queries) else np.array([], np.int64)
        ids = np.empty(len(queries), np.int64)
        ids[q_order] = flat
        src, dst = ids[:n_local], ids[n_local:]

    # ---- stage 2: undirected mirroring (local) + global concat indices ----
    gidx = e_offset + np.arange(n_local, dtype=np.int64)
    if not directed:
        # mirror_dedup concat order: [all originals ..., all reversed ...]
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.concatenate([w, w])
        gidx = np.concatenate([gidx, e_total + gidx])

    # ---- stage 3: route edges to the owner of their source range ----
    v_p = -(-n_vertices // n_shards) if n_vertices else 1
    owner = np.minimum(src // v_p // rpp, nparts - 1)
    payload = np.stack(
        [src, dst, w.view(np.int32).astype(np.int64), gidx], axis=1
    )
    blocks, _, _ = _route(payload, owner, nparts)
    recv = yield blocks
    mine = (
        np.concatenate([r for r in recv if len(r)])
        if any(len(r) for r in recv)
        else np.zeros((0, 4), np.int64)
    )
    src = mine[:, 0]
    dst = mine[:, 1]
    w = mine[:, 2].astype(np.int32).view(np.float32).copy()
    gidx = mine[:, 3]

    # ---- stage 4: dedup (undirected) + trim, in global-index order ----
    order = np.argsort(gidx, kind="stable")
    src, dst, w, gidx = src[order], dst[order], w[order], gidx[order]
    if not directed and len(src):
        # first-occurrence dedup == min gidx per (src, dst): rows are in
        # ascending-gidx order, so the stable key sort's first row per key
        # reproduces mirror_dedup's duplicate winner exactly.  Survivors
        # STAY key-sorted — the native mirror emits (src, dst) order, and
        # the monolithic trim consumes that order
        key = src * n_vertices + dst
        korder = np.argsort(key, kind="stable")
        ks = key[korder]
        first = np.ones(len(ks), bool)
        first[1:] = ks[1:] != ks[:-1]
        keep = korder[first]
        src, dst, w, gidx = src[keep], dst[keep], w[keep], gidx[keep]
    if len(src):
        # native per-vertex Fisher-Yates streams are keyed on the GLOBAL
        # vertex id and consume the vertex's edges in array order —
        # ascending gidx reproduces the monolithic pass bit-for-bit
        keep = native.trim_hotspot(
            src.astype(np.int32), n_vertices, max_out_degree, seed_val
        )
        kept = np.flatnonzero(keep)
        src, dst, w, gidx = src[kept], dst[kept], w[kept], gidx[kept]

    # local CSR over my vertex span [lo, hi): local edge offsets
    lo, hi = pid * rpp * v_p, min((pid + 1) * rpp * v_p, n_vertices)
    span = max(hi - lo, 0)
    corder = np.lexsort((dst, src))  # stable: parallel edges keep gidx order
    indices32 = dst[corder].astype(np.int32)
    weights32 = w[corder]
    counts = np.bincount((src - lo).astype(np.int64), minlength=span)
    indptr_local = np.zeros(span + 1, np.int64)
    np.cumsum(counts, out=indptr_local[1:])
    e_local = len(indices32)

    # ---- stage 5: reverse metadata via producer/consumer range exchange ----
    # producer: for each local edge (v -> u), the mirrored edge (u -> v) gets
    # rev_w = w(v->u), pfx = weight-CDF prefix of u within N(v), and deg(v)
    # (the membership pass's min-side test needs the far endpoint's degree)
    rev_w = np.zeros(e_local, np.float32)
    pfx = np.zeros(e_local, np.float32)
    big = np.int64(np.iinfo(np.int64).max)
    deg_dst = np.full(e_local, big, np.int64)
    has_bit = np.zeros(e_local, bool)
    keys = np.zeros(0, np.int64)
    if e_local:
        deg_l = np.diff(indptr_local)
        src_rep = np.repeat(np.arange(lo, hi, dtype=np.int64), deg_l)
        keys = src_rep * n_vertices + indices32  # sorted (CSR row order)
        v_ids = np.repeat(np.arange(lo, hi, dtype=np.int64), deg_l)
        degs_rep = np.repeat(deg_l.astype(np.int64), deg_l)
        u_ids = indices32.astype(np.int64)
        cw = np.concatenate([[0.0], np.cumsum(weights32, dtype=np.float64)])
        row_base = cw[np.repeat(indptr_local[:-1], deg_l)]
        pfx_out = (cw[:-1] - row_base).astype(np.float32)
        rec = np.stack(
            [
                u_ids,
                v_ids,
                weights32.view(np.int32).astype(np.int64),
                pfx_out.view(np.int32).astype(np.int64),
                degs_rep,
            ],
            axis=1,
        )
        rec_owner = np.minimum(u_ids // v_p // rpp, nparts - 1)
        blocks, _, _ = _route(rec, rec_owner, nparts)
    else:
        blocks = [np.zeros((0, 5), np.int64)] * nparts
    recv = yield blocks
    inbound = (
        np.concatenate([r for r in recv if len(r)])
        if any(len(r) for r in recv)
        else np.zeros((0, 5), np.int64)
    )
    if len(inbound) and e_local:
        # consumer: match records (u, v) into my sorted rows
        rkeys = inbound[:, 0] * n_vertices + inbound[:, 1]
        pos = np.searchsorted(keys, rkeys)
        pos_c = np.minimum(pos, max(e_local - 1, 0))
        found = (pos < e_local) & (keys[pos_c] == rkeys)
        rev_w[pos_c[found]] = (
            inbound[found, 2].astype(np.int32).view(np.float32)
        )
        pfx[pos_c[found]] = inbound[found, 3].astype(np.int32).view(np.float32)
        deg_dst[pos_c[found]] = inbound[found, 4]

    # membership pass (exact triangle bits): edges on the MIN side —
    # (deg(u), u) < (deg(v), v), or the reverse edge is absent
    # (deg_dst stays +inf) — query owner(v) with N(u) shipped once per peer;
    # self-loops resolve locally (N(u) ∩ N(u) nonempty since the edge exists)
    if e_local:
        deg_l = np.diff(indptr_local)
        u_ids = np.repeat(np.arange(lo, hi, dtype=np.int64), deg_l)
        v_ids = indices32.astype(np.int64)
        d_u = np.repeat(deg_l.astype(np.int64), deg_l)
        selfe = u_ids == v_ids
        has_bit |= selfe
        qm = ~selfe & ((d_u < deg_dst) | ((d_u == deg_dst) & (u_ids < v_ids)))
        q_owner = np.minimum(v_ids // v_p // rpp, nparts - 1)
        q_blocks = []
        for t in range(nparts):
            sel = qm & (q_owner == t)
            q_blocks.append(
                _membership_encode(
                    u_ids[sel], v_ids[sel], indptr_local, indices32, lo
                )
            )
    else:
        q_blocks = [
            np.array([[0], [0], [0]], np.int64) for _ in range(nparts)
        ]
    recv = yield q_blocks
    # answers ride back in the mirrored bucket layout (exchange involution)
    answers = [
        _membership_answer(r, keys, n_vertices) for r in recv
    ]
    recv = yield answers
    mirror_blocks = [np.zeros((0, 3), np.int64)] * nparts
    ans_in = (
        np.concatenate([r for r in recv if len(r)])
        if any(len(r) for r in recv)
        else np.zeros((0, 3), np.int64)
    )
    if len(ans_in) and e_local:
        akeys = ans_in[:, 0] * n_vertices + ans_in[:, 1]
        pos = np.searchsorted(keys, akeys)  # exact: I own these edges
        upd = np.zeros(e_local, bool)
        np.logical_or.at(upd, pos, ans_in[:, 2] != 0)
        has_bit |= _propagate_dup_bits(keys, upd)
        # mirror the answered bit to the reverse edge (v -> u) at owner(v)
        m_owner = np.minimum(ans_in[:, 1] // v_p // rpp, nparts - 1)
        mirror_blocks, _, _ = _route(ans_in, m_owner, nparts)
    recv = yield mirror_blocks
    mm = (
        np.concatenate([r for r in recv if len(r)])
        if any(len(r) for r in recv)
        else np.zeros((0, 3), np.int64)
    )
    if len(mm) and e_local:
        mkeys = mm[:, 1] * n_vertices + mm[:, 0]
        pos = np.searchsorted(keys, mkeys)
        pos_c = np.minimum(pos, max(e_local - 1, 0))
        found = (pos < e_local) & (keys[pos_c] == mkeys)
        upd = np.zeros(e_local, bool)
        np.logical_or.at(upd, pos_c[found], mm[found, 2] != 0)
        has_bit |= _propagate_dup_bits(keys, upd)
    rev_bits = rev_w.view(np.int32)
    rev_enc = np.where(has_bit, rev_bits | np.int32(_SIGN), rev_bits).astype(
        np.int32
    )

    # ---- stage 6: pack my ranges into the blocked layout ----
    max_deg_local = int(np.diff(indptr_local).max()) if span else 0
    recv = yield [np.array([[max_deg_local]], np.int64)] * nparts
    max_deg = max(int(r[0, 0]) for r in recv)
    p_l = 31 if light_width is None else light_width
    maxb = _max_blocks(p_l)
    if block_width is None:
        need = -(-max_deg // maxb) if max_deg > p_l else 1
        block_width = max(256, 1 << int(np.ceil(np.log2(max(need, 1)))))
    c = block_width
    _check_capacity(max_deg, p_l, c)

    # pad my span to rpp full ranges of v_p rows (isolated tail vertices)
    full_span = rpp * v_p
    if full_span > span:
        indptr_local = np.concatenate(
            [indptr_local, np.full(full_span - span, indptr_local[-1], np.int64)]
        )
    deg_all = np.diff(indptr_local)
    heavy_blocks = np.where(deg_all > p_l, -(-deg_all // c), 0)
    nb_mine = max(
        (
            int(heavy_blocks[s * v_p : (s + 1) * v_p].sum())
            for s in range(rpp)
        ),
        default=0,
    )
    recv = yield [np.array([[nb_mine]], np.int64)] * nparts
    nb_p = max(max(int(r[0, 0]) for r in recv), 1)

    zero_bits = np.float32(0.0).view(np.int32)
    lights, biws, bidss, brps = [], [], [], []
    for s in range(rpp):
        l, b_iw, b_ids, b_rp = _pack_range(
            indptr_local, indices32, weights32, rev_enc, pfx,
            s * v_p, (s + 1) * v_p, p_l, c,
        )
        biw = np.full((nb_p, 2 * c), PAD_ID, np.int32)
        biw[:, c:] = zero_bits
        biw[: b_iw.shape[0]] = b_iw
        bids = np.full((nb_p, c), PAD_ID, np.int32)
        bids[: b_ids.shape[0]] = b_ids
        brp = np.zeros((nb_p * c // QUADS_PER_ROW, 128), np.int32)
        brp[: b_rp.shape[0]] = b_rp
        lights.append(l)
        biws.append(biw)
        bidss.append(bids)
        brps.append(brp)

    meta = {
        "n_vertices": n_vertices,
        "n_shards": n_shards,
        "rows_per_shard": v_p,
        "blocks_per_shard": nb_p,
        "light_width": p_l,
        "block_width": c,
    }
    return DistributedBuildResult(
        pid=pid,
        ranges=list(range(pid * rpp, (pid + 1) * rpp)),
        light=np.concatenate(lights),
        biw=np.concatenate(biws),
        bids=np.concatenate(bidss),
        brp=np.concatenate(brps),
        indptr=indptr_local,
        indices=indices32,
        weights=weights32,
        rev_enc=rev_enc,
        pfx=pfx,
        names=names,
        name_base=name_base,
        meta=meta,
    )


# --------------------------------------------------------------------------- #
# drivers


def run_local(gens) -> list:
    """Drive ``nparts`` participant generators in lockstep within one
    process (the unit-test / single-host driver)."""
    n = len(gens)
    sends = [next(g) for g in gens]
    results = [None] * n
    live = [True] * n
    while any(live):
        assert all(live), "participants desynchronized"
        new_sends = [None] * n  # snapshot: deliver THIS round's sends only
        for i in range(n):
            recv = [sends[j][i] for j in range(n)]
            try:
                new_sends[i] = gens[i].send(recv)
            except StopIteration as e:
                results[i] = e.value
                live[i] = False
        sends = new_sends
    return results


def build_mesh1d():
    """The build's exchange mesh: every rank of the world on one data axis
    (``make_mesh(n_model=1)``), on this rank's card over NCCL (which carries
    device tensors only) and on the CPU otherwise."""
    import torch.distributed as dist

    from node2vec_torch.parallel.mesh import make_mesh

    nccl = dist.is_initialized() and dist.get_backend() == "nccl"
    return make_mesh(n_model=1, device="cuda" if nccl else "cpu")


def run_distributed(gen, mesh=None):
    """Drive THIS rank's participant with real exchanges between processes.

    Each ``yield`` becomes an all-gather of the row counts (and widths) and
    one padded all_to_all over the flattened ``mesh`` (``build_mesh1d()``
    when None; participant ``pid`` must be the mesh's flat rank): int64
    tensors in host memory over gloo, on the mesh's device over NCCL.  A
    host only ever holds its own shard plus one round's padded buckets."""
    if mesh is None:
        mesh = build_mesh1d()
    nparts = mesh.n_devices
    me = mesh.rank
    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")

    def exchange(send):
        if len(send) != nparts:
            raise ValueError(f"a participant sent {len(send)} blocks to {nparts} ranks")
        counts = [len(b) for b in send]
        width = max((b.shape[1] for b in send if b.ndim == 2), default=1)
        head = torch.tensor(counts + [width], dtype=torch.int64, device=dev)
        # [nparts, nparts + 1]: row i's rows sent to each rank, then its width
        table = mesh.all_gather(head[None], mesh.world).cpu().numpy()
        cap = max(int(table[:, :nparts].max()), 1)
        width = int(table[:, nparts].max())
        buf = np.zeros((nparts, cap, width), np.int64)
        for j, b in enumerate(send):
            if len(b):
                buf[j, : len(b), : b.shape[1]] = b
        out = mesh.all_to_all(torch.from_numpy(buf.reshape(nparts * cap, width)).to(dev),
                              mesh.world).cpu().numpy().reshape(nparts, cap, width)
        return [out[i, : int(table[i, me])] for i in range(nparts)]

    try:
        send = next(gen)
        while True:
            send = gen.send(exchange(send))
    except StopIteration as e:
        return e.value


def assemble_partitioned(result: DistributedBuildResult, mesh=None, device="cuda",
                         axis_name: str = "data"):
    """This participant's shards as a ``PartitionedBlockedGraph`` holding
    shards ``result.ranges`` (the layout of ``partition_blocked_graph`` and
    ``load_partitioned_graph(shards=)``), on ``device``, or with ``mesh``
    on the mesh's device; there this rank's data coordinate must be one of
    its ranges."""
    from node2vec_torch.parallel.edge_partitioned_blocked import PartitionedBlockedGraph

    m = result.meta
    if mesh is not None:
        device = mesh.device
        if mesh.coords[axis_name] not in result.ranges:
            raise ValueError(f"participant {result.pid} holds ranges {result.ranges}, not this "
                             f"rank's '{axis_name}' shard {mesh.coords[axis_name]}")
    tables = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
              for a in (result.light, result.biw, result.bids, result.brp)]
    return PartitionedBlockedGraph(
        *tables, rows_per_shard=m["rows_per_shard"], blocks_per_shard=m["blocks_per_shard"],
        light_width=m["light_width"], block_width=m["block_width"], n_vertices=m["n_vertices"],
        shards=tuple(int(s) for s in result.ranges))
