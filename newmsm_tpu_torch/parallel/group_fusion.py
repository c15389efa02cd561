"""The groupwise fusion optimiser, subject-sharded over ranks.

Port of newmsm_tpu/parallel/group_fusion.py: the fusion-move sweep of
Fusion::optimize (Fusion.h:122-244) on the DiscreteGroupModel energy
(DiscreteGroupCostFunction.cpp:26-98), with the subjects spread over the
ranks of a process group (parallel/multihost.SubjectComm; one rank when
there is none):

  - label-deformed template maps (get_patch_data, DiscreteGroupModel.cpp:
    88-121), subject by subject through ops.resample.label_deformed_maps,
    each rank for its own subjects, with no collective;
  - cross-subject CP correspondences (estimate_pairs,
    DiscreteGroupModel.cpp:37-55) on the DEFORMED CP grids, all S*K CPs
    searched on every rank after one all-gather of the grids;
  - per fusion alpha step, the binary move tables: the subject triplet
    tables in one batch of all S subjects on every rank; the (a,b) pair
    blocks go round-robin to the ranks when the ranks see the other
    subjects' maps by one all-gather a call ('gather'); under a ring
    exchange a step ('ring') a block goes to the rank that holds both
    subjects at a step. The pair tables are combined by a sum of disjoint
    slots; then every rank runs the binary ICM of reg/optimise/fusion.py on
    identical tables, multi-start like the pairwise solver (on the card
    one launch of its kernel, K2, whose sums have a fixed order).

Determinism: every batch has a shape that does not depend on the rank
count W. The partner search and the triplet tables are the one-rank batch
itself, repeated on every rank (their cost is small beside the pair
blocks, so W-fold work there is cheaper than a collective and keeps one
rank's batching); the label maps and the apply stage go one subject at a
time; patch rows and pair blocks go in fixed chunks, the last one padded.
A subject's rows are copied to an allocation of their own before the
per-subject stages, and ranks combine work only by concatenation,
disjoint-slot sums and MAX. So for any W that divides S the partner map,
labeling and energy are bitwise those of one rank
(tests/test_torch_sharded.py).

A pair block's template patch depends on (subject, CP, label) only, not on
alpha or on the partner, so the patches of a call are built once and every
alpha step gathers from them; the JAX package recomputes them inside each
alpha step (one fused XLA program). The values are the same.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import FIX_NAN, FOLDING, RAD, resolve_device, trace
from ..core import spherical as sph
from ..ops import icm
from ..ops import similarity as simi
from ..ops.nearest import SearchTables, _search
from ..ops.strain import triangular_strain
from ..reg.optimise import fusion as FU
from .multihost import SubjectComm

FUSION_SEED = 7      # the JAX package's fusion start key, PRNGKey(7)


class GroupLevelStatics(NamedTuple):
    """Per-level constants (tensors on the level's device)."""
    labels: torch.Tensor        # (L,3)
    centre: torch.Tensor        # (3,)
    orig_cp: torch.Tensor       # (K,3) pristine CP grid
    cp_faces: torch.Tensor      # (T,3) sorted CP faces, int64
    tmpl_coords: torch.Tensor   # (Nt,3)
    mask_w: Optional[torch.Tensor]   # (Nt,) |mask| weights or None
    # CP-grid search topology (shared across subjects; coords swapped per call)
    cp_search: SearchTables
    mu: float
    kappa: float
    k_exp: float
    rexp: float
    reglambda: float
    subcorr: float
    simval: int
    percentile: float
    pmax: int
    cprange: float
    fixnan: bool
    sweeps: int = 2
    icm_passes: int = 4
    n_restarts: int = 2


class GroupIterTables(NamedTuple):
    """Per-iteration incidence / colouring tables, host-built from the
    partner map. The JAX package pads these to bucket shapes so that one
    compiled program serves every iteration; here they have their true
    sizes and the colour groups are a tuple of id tensors, and flat for
    the ICM kernel (fusion.color_tables)."""
    groups: tuple                   # per colour, the (G_c,) node ids
    color_ids: torch.Tensor         # (S*K,) int32: the groups, flat
    color_offsets: torch.Tensor     # (C+1,) int32
    vert_tri: torch.Tensor          # (S*K,MT) incident triplet ids, -1 padded
    vert_tri_corner: torch.Tensor   # (S*K,MT)
    vert_pair: torch.Tensor         # (S*K,MP) incident pair ids, -1 padded
    vert_pair_end: torch.Tensor     # (S*K,MP) own end (0/1)
    colors: np.ndarray              # (S*K,) the node colouring (host)


# --------------------------------------------------------------------------
# canonical pair-block enumeration
# --------------------------------------------------------------------------

def pair_blocks(S: int) -> np.ndarray:
    """(B,2) all (a,b) a<b in lexicographic order; pair id = block*K + v,
    matching the reference's pair construction order
    (DiscreteGroupModel.cpp:37-55 up to its per-vertex interleaving)."""
    return np.array([(a, b) for a in range(S) for b in range(a + 1, S)],
                    np.int32).reshape(-1, 2)


def _round_robin_slots(n_items: int, n_dev: int) -> np.ndarray:
    """(n_dev, n_slots) item ids per rank, -1 padded; item i -> rank
    i % n_dev."""
    n_slots = -(-n_items // n_dev) if n_items else 0
    out = np.full((n_dev, max(1, n_slots)), -1, np.int32)
    for i in range(n_items):
        out[i % n_dev, i // n_dev] = i
    return out


def _ring_local_pairs(nl: int) -> np.ndarray:
    """(n0,2) local (i,j) i<j pairs for the r=0 (own-block) ring step,
    -1 padded to at least one row."""
    ij = [(i, j) for i in range(nl) for j in range(i + 1, nl)]
    out = np.full((max(1, len(ij)), 2), -1, np.int32)
    for s, (i, j) in enumerate(ij):
        out[s] = (i, j)
    return out


def _block_id(a, b, S: int):
    """Lexicographic pair-block id of (a,b), a<b (pair_blocks order)."""
    return a * S - (a * (a + 1)) // 2 + (b - a - 1)


# --------------------------------------------------------------------------
# host-side incidence + colouring (per iteration; partner-dependent)
# --------------------------------------------------------------------------

def _padded_incidence(keys: np.ndarray, n_rows: int, *values):
    """Rows keyed by `keys` (stable order within a row), -1 / 0 padded:
    the first value table is padded with -1, the others with 0."""
    order = np.argsort(keys, kind="stable")
    k_s = keys[order]
    counts = np.bincount(k_s, minlength=n_rows)
    width = max(1, int(counts.max()))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(k_s)) - starts[k_s]
    out = []
    for i, v in enumerate(values):
        tab = np.full((n_rows, width), -1 if i == 0 else 0, np.int32)
        tab[k_s, pos] = v[order]
        out.append(tab)
    return out


def _triplet_incidence(cp_faces: np.ndarray, K: int):
    """Per-vertex (triplet id, corner) incidence lists, -1 padded:
    (K,mt) x2."""
    T = cp_faces.shape[0]
    tids = np.repeat(np.arange(T, dtype=np.int64), 3)
    corners = np.tile(np.arange(3, dtype=np.int32), T)
    verts = cp_faces.reshape(-1).astype(np.int64)
    return _padded_incidence(verts, K, tids, corners)


def _greedy_color(src_sorted: np.ndarray, dst_sorted: np.ndarray,
                  N: int) -> np.ndarray:
    """First-fit colouring in node order over a CSR edge list (sorted by
    src)."""
    deg = np.bincount(src_sorted, minlength=N)
    row = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    colors = np.full(N, -1, np.int32)
    stamp = np.full(256, -1, np.int64)
    for n in range(N):
        cs = colors[dst_sorted[row[n]:row[n + 1]]]
        stamp[cs[cs >= 0]] = n
        c = 0
        while stamp[c] == n:
            c += 1
        colors[n] = c
    return colors


# per-level memo: the partner map usually stabilises after the first
# iterations, and rebuilding tables is pure host work
_ITER_TABLE_CACHE: dict = {}
_ITER_TABLE_CACHE_MAX = 8


def build_iteration_tables(partner: np.ndarray, cp_faces: np.ndarray,
                           S: int, K: int, device=None) -> GroupIterTables:
    """Incidence lists + conflict-free node colouring for the groupwise MRF:
    nodes (s,k), per-subject triplet cliques, cross-subject pair edges
    (a*K+v, b*K+partner[a,b,v]). Memoised on the partner map (it stabilises
    as the registration converges). `device` None means cuda."""
    dev = resolve_device(device)
    partner = np.ascontiguousarray(partner)
    cp_faces = np.asarray(cp_faces)
    key = (S, K, cp_faces.shape[0], str(dev), hash(partner.tobytes()))
    hit = _ITER_TABLE_CACHE.get(key)
    if hit is not None:
        trace.table_hit()
        return hit
    with trace.table_miss():
        out = _iteration_tables(partner, cp_faces, S, K, dev)
    if len(_ITER_TABLE_CACHE) >= _ITER_TABLE_CACHE_MAX:
        _ITER_TABLE_CACHE.pop(next(iter(_ITER_TABLE_CACHE)))
    _ITER_TABLE_CACHE[key] = out
    return out


def _iteration_tables(partner, cp_faces, S: int, K: int, dev):
    blocks = pair_blocks(S)
    B = blocks.shape[0]
    N = S * K
    T = cp_faces.shape[0]

    # ---- triplet incidence: per-subject copy of the CP incidence ---------
    vert_tri1, vert_corner1 = _triplet_incidence(cp_faces, K)
    mt = vert_tri1.shape[1]
    offs = (np.arange(S, dtype=np.int32) * T)[:, None, None]
    vert_tri = np.where(vert_tri1[None] >= 0, vert_tri1[None] + offs,
                        -1).reshape(N, mt)
    vert_tri_corner = np.tile(vert_corner1, (S, 1))

    # ---- pair endpoints --------------------------------------------------
    a_arr, b_arr = blocks[:, 0], blocks[:, 1]
    v = np.arange(K, dtype=np.int32)
    p_ids = (np.arange(B, dtype=np.int32)[:, None] * K + v[None]).ravel()
    e0 = (a_arr[:, None] * K + v[None]).ravel()
    e1 = (b_arr[:, None] * K + partner[a_arr, b_arr]).ravel().astype(np.int64)
    vert_pair, vert_pair_end = _padded_incidence(
        np.concatenate([e0.astype(np.int64), e1]), N,
        np.concatenate([p_ids, p_ids]),
        np.concatenate([np.zeros_like(p_ids), np.ones_like(p_ids)]))

    # ---- colouring: CSR adjacency (triplet + pair edges), greedy ---------
    ta, tb, tc = ((cp_faces[:, i][None] + np.arange(S)[:, None] * K).ravel()
                  for i in range(3))
    src = np.concatenate([ta, ta, tb, tb, tc, tc, e0, e1])
    dst = np.concatenate([tb, tc, ta, tc, ta, tb, e1, e0])
    order = np.argsort(src, kind="stable")
    colors = _greedy_color(src[order], dst[order], N)

    def put(a):
        return torch.from_numpy(a.astype(np.int64)).to(dev)

    return GroupIterTables(
        **FU.color_tables([np.nonzero(colors == c)[0]
                           for c in range(int(colors.max()) + 1)], dev),
        vert_tri=put(vert_tri), vert_tri_corner=put(vert_tri_corner),
        vert_pair=put(vert_pair), vert_pair_end=put(vert_pair_end),
        colors=colors)


# --------------------------------------------------------------------------
# partner map (estimate_pairs)
# --------------------------------------------------------------------------

def make_partner_fn(st: GroupLevelStatics, S: int,
                    comm: Optional[SubjectComm] = None):
    """cp (S/W,K,3) this rank's subjects -> partner (S,S,K) int64 on every
    rank: partner[a,b,v] = closest CP vertex in subject b's grid to subject
    a's CP v (get_closest_vertex_ID through the deformed grids,
    DiscreteGroupModel.cpp:37-55). The grids are all-gathered and every
    rank runs the one-rank search: S searches of all S*K CPs."""
    comm = comm or SubjectComm()

    def run(cp_loc):
        cp = comm.all_gather(cp_loc)
        K = cp.shape[1]
        q = cp.reshape(S * K, 3)            # every subject's CPs, one search
        cols = []
        for b in range(S):
            # swap in the DEFORMED grid coordinates and drop the pristine /
            # descent shortcuts, which are only valid for the undeformed
            # icosphere: leaving pristine_res set would silently answer the
            # search on the pristine geometry
            tabs = dataclasses.replace(st.cp_search, coords=cp[b],
                                       pristine_res=-1, descent=())
            _, tv, vc = _search(q, tabs)
            d = torch.linalg.norm(vc - q[:, None, :], dim=-1)
            sel = torch.argmin(d, dim=1)
            cols.append(torch.gather(tv, 1, sel[:, None])[:, 0].reshape(S, K))
        return torch.stack(cols, dim=1)                          # (S,S,K)

    return run


# --------------------------------------------------------------------------
# label maps (get_patch_data resampling stage)
# --------------------------------------------------------------------------

def make_maps_fn(st: GroupLevelStatics, dg_topology, cap: int):
    """(dg_coords (n,N,3), dg_data (n,D,N)) -> maps (n,L,D,Nt), subject by
    subject (a rank passes its own n subjects; no collective). Each
    subject's rows are copied to an allocation of their own first: a row
    view's address depends on the subject's place in the rank's block, and
    on the card a kernel may choose its vector width by the address."""
    from ..ops.resample import label_deformed_maps
    dg_faces, dg_tri_idx, dg_ring_faces, dg_ring_verts, tmpl_tables, \
        tmpl_vareas = dg_topology

    def run(dg_coords, dg_data):
        return torch.stack([
            label_deformed_maps(c.clone(), d.clone(), dg_faces, dg_tri_idx,
                                dg_ring_faces, dg_ring_verts, st.labels,
                                st.centre, tmpl_tables, tmpl_vareas, cap=cap)
            for c, d in zip(dg_coords, dg_data)])

    return run


# --------------------------------------------------------------------------
# the fusion optimisation step
# --------------------------------------------------------------------------

def _geodesic_from_chord(chord):
    return 2.0 * RAD * torch.arcsin((chord / (2 * RAD)).clamp(-1, 1))


def _padded_chunks(n: int, size: int):
    """(start, stop) of chunks of `size` over n items: every chunk is
    computed at `size` rows (the last one padded), so that its rounding
    does not follow the item count."""
    return [(s, min(s + size, n)) for s in range(0, n, size)]


def _pad_rows(t, size: int):
    """t with its first row repeated up to `size` rows."""
    pad = size - t.shape[0]
    return t if pad == 0 else torch.cat([t, t[:1].expand((pad,)
                                                         + t.shape[1:])])


class GroupFusion:
    """The fusion sweep of one level, on this rank's share of the subjects.
    Call:

        (maps (S/W,L,D,Nt), cp (S/W,K,3), spac (S/W,K) of this rank's
         subjects, labeling (S*K,) int64, partner (S,S,K) int64,
         tables: GroupIterTables)
          -> (labeling (S*K,), energy (), patch_need ()), equal on every
             rank

    patch_need is the MAX in-range template-vertex count over all (CP,
    label) patch requests; above st.pmax means patches were truncated and
    the caller must grow pmax to this and redo.

    maps_exchange, how a rank sees the other subjects' label maps (the
    (S,L,D,Nt) tensor, the dominant memory term):
      'gather': one all-gather a call; pair blocks go round-robin to the
        ranks; every rank holds the whole tensor.
      'ring': a rank's maps memory stays O(S/W): each alpha step passes the
        resident block around the ring (W//2+1 steps, each unordered pair
        of rank blocks meeting once; the even-W antipodal step is kept by
        the lower rank). The block costs are those of 'gather', so the
        results are the same bits.

    The stages are methods so that the tests can hold each against the JAX
    package from identical state: `prepare` (label positions and patches of
    one call), `build_tables_for` (one alpha's binary tables; `maps` is the
    gathered tensor under 'gather', the rank's own under 'ring'),
    `alpha_step`.

    Random starts: `random_starts(alpha)` -> (n_restarts, S*K) int tensor
    when given, else drawn from `generator` once per alpha and kept, so an
    alpha's starts are the same in every sweep and iteration (as the JAX
    package's, which folds alpha into a fixed key). Every rank draws the
    same starts."""

    # rows of one patch-distance chunk: (rows, Nt) float32 each
    PATCH_CHUNK_ELEMS = 1 << 26
    # elements of one pair-block batch: (blocks, K, 2, 2, D, pmax)
    PAIR_CHUNK_ELEMS = 1 << 26

    def __init__(self, st: GroupLevelStatics, S: int,
                 generator: Optional[torch.Generator] = None,
                 random_starts: Optional[Callable] = None,
                 comm: Optional[SubjectComm] = None,
                 maps_exchange: str = "gather"):
        if maps_exchange not in ("gather", "ring"):
            raise ValueError(f"unknown maps_exchange {maps_exchange!r}")
        self.comm = comm = comm or SubjectComm()
        if S % comm.world:
            raise ValueError(f"S={S} not divisible by {comm.world} ranks")
        self.st = st
        self.S = S
        self.K = st.orig_cp.shape[0]
        self.L = st.labels.shape[0]
        self.T = st.cp_faces.shape[0]
        self.dev = st.labels.device
        self.maps_exchange = maps_exchange
        blocks = pair_blocks(S).astype(np.int64)
        self.blocks = torch.from_numpy(blocks).to(self.dev)
        self.B = blocks.shape[0]
        self.pair_chunk_blocks = self.pair_chunks = 0
        self.generator = generator
        self.random_starts = random_starts
        self._starts: dict = {}
        self.trip_nodes = (st.cp_faces[None] + (torch.arange(
            S, device=self.dev) * self.K)[:, None, None]).reshape(-1, 3)

        # this rank's pair blocks as (block id, a, b, row of a, row of b in
        # the maps it reads) for each exchange step
        W, rank = comm.world, comm.rank
        nl = S // W
        if maps_exchange == "gather":
            ids = [int(i) for i in _round_robin_slots(self.B, W)[rank]
                   if i >= 0]
            plan = [[(i, *blocks[i], *blocks[i]) for i in ids]]
        else:
            plan = []
            for r in range(W // 2 + 1):
                v = (rank - r) % W
                step = []
                if r == 0:
                    for i, j in _ring_local_pairs(nl):
                        if i >= 0:
                            a, b = rank * nl + i, rank * nl + j
                            step.append((_block_id(a, b, S), a, b, i, j))
                elif 2 * r != W or rank < v:
                    for i in range(nl):
                        for j in range(nl):
                            ga, gb = rank * nl + i, v * nl + j
                            wa, wb = (i, nl + j) if ga < gb else (nl + j, i)
                            a, b = min(ga, gb), max(ga, gb)
                            step.append((_block_id(a, b, S), a, b, wa, wb))
                plan.append(step)
        # the patches this rank reads: those of its blocks' first subjects
        # (under 'ring' a visiting subject is the first one of a block
        # whenever its index is the lower)
        patch_subjects = sorted({int(row[1]) for step in plan
                                 for row in step})
        self.plan = [torch.tensor(step, dtype=torch.int64,
                                  device=self.dev).reshape(-1, 5)
                     for step in plan]
        self.patch_subjects = patch_subjects
        a_slot = torch.full((S,), -1, dtype=torch.int64)
        a_slot[patch_subjects] = torch.arange(len(patch_subjects))
        self.a_slot = a_slot.to(self.dev)

    # ---- per-call state --------------------------------------------------
    def patch_of(self, pos, limit):
        """pos (R,3), limit (R,) -> (idx (R,pmax), in_range (R,pmax) bool,
        n_inrange (R,) count of template vertices within `limit`, which
        detects silent top-k truncation against st.pmax). Chunks of a fixed
        row count, the last one padded."""
        st = self.st
        tmpl = st.tmpl_coords
        tsq = (tmpl ** 2).sum(1)
        rows = max(1, min(self.PATCH_CHUNK_ELEMS // tmpl.shape[0],
                          self.K * self.L))
        idx, rng, n_in = [], [], []
        for s, e in _padded_chunks(pos.shape[0], rows):
            p = _pad_rows(pos[s:e], rows)
            lim = _pad_rows(limit[s:e], rows)
            d2 = tsq - 2.0 * (p @ tmpl.T) + (p * p).sum(-1)[:, None]
            dist = _geodesic_from_chord(torch.sqrt(d2.clamp(min=0.0)))
            n_in.append((dist < lim[:, None]).sum(-1)[:e - s])
            near, ix = torch.topk(dist, st.pmax, dim=-1, largest=False)
            idx.append(ix[:e - s])
            rng.append((near < lim[:, None])[:e - s])
        return torch.cat(idx), torch.cat(rng), torch.cat(n_in)

    def prepare(self, cp, spac):
        """This call's label positions rl (S,K,L,3), from the all-gathered
        cp (S,K,3) and spac (S,K), and the template patch of every (a, CP,
        label) this rank's pair blocks can ask for, a one of their first
        subjects (state["p_idx"][a_slot[a]]). patch_need is MAX-combined
        over the ranks. Returns a dict."""
        st, K, L = self.st, self.K, self.L
        cp, spac = self.comm.all_gather(cp), self.comm.all_gather(spac)
        rots = sph.rodrigues(st.centre.expand(cp.shape), cp)
        rl = torch.einsum("skij,lj->skli", rots, st.labels)      # (S,K,L,3)
        idx, rng = [], []
        need = torch.zeros((), dtype=torch.int64, device=self.dev)
        for a in self.patch_subjects:
            lim = (st.cprange * spac[a])[:, None].expand(K, L)
            i, r, n = self.patch_of(rl[a].reshape(-1, 3), lim.reshape(-1))
            idx.append(i.reshape(K, L, st.pmax))
            rng.append(r.reshape(K, L, st.pmax))
            need = torch.maximum(need, n.max())
        shape = (0, K, L, st.pmax)
        return dict(
            rl=rl, cp=cp, spac=spac,
            p_idx=torch.stack(idx) if idx else torch.zeros(
                shape, dtype=torch.int64, device=self.dev),
            p_rng=torch.stack(rng) if rng else torch.zeros(
                shape, dtype=torch.bool, device=self.dev),
            patch_need=self.comm.max(need))

    # ---- binary move tables ---------------------------------------------
    def triplet_block(self, state, lab_sk, alpha):
        """(S,T,8) binary triplet tables of every subject (strain +
        folding, DiscreteGroupCostFunction.cpp:26-52)."""
        st = self.st
        tf = st.cp_faces
        rl, cp = state["rl"], state["cp"]
        cur = lab_sk[:, tf]                                      # (S,T,3)
        b = FU.bits(self.dev)
        alpha_t = torch.full_like(cur[..., 0:1], alpha)
        s_ix = torch.arange(self.S, device=self.dev)[:, None, None]
        corners = []
        for i in range(3):
            lab = torch.where(b[None, None, :, i] == 1, alpha_t,
                              cur[..., i:i + 1])                 # (S,T,8)
            corners.append(rl[s_ix, tf[None, :, i, None], lab])  # (S,T,8,3)
        va, vb, vc = corners
        cur_tri = cp[:, tf]                                      # (S,T,3,3)
        n_cur = sph.tri_normal(cur_tri[..., 0, :], cur_tri[..., 1, :],
                               cur_tri[..., 2, :])
        n_def = sph.tri_normal(va, vb, vc)
        folded = (n_def * n_cur[:, :, None, :]).sum(-1) < 0.0
        o = st.orig_cp[tf]                                       # (T,3,3)
        ob = o[None, :, None].expand(va.shape[:3] + (3, 3))
        strain = triangular_strain(ob, torch.stack([va, vb, vc], dim=-2),
                                   st.mu, st.kappa, st.k_exp)
        cost = st.subcorr * st.reglambda * torch.pow(strain, st.rexp)
        if st.fixnan:
            cost = torch.where(torch.isnan(cost),
                               torch.full_like(cost, FIX_NAN), cost)
        return torch.where(folded, torch.full_like(cost, FOLDING), cost)

    def pair_block_cost(self, state, maps, partner, lab_sk, alpha, rows):
        """(b,K,4) binary pair tables of the blocks `rows` (b,5) = (block
        id, a, b, row of a's maps, row of b's maps in `maps`), a<b: combos
        indexed x_a*2 + x_b, x=1 means switch to alpha. Reproduces
        DiscreteGroupCostFunction::computePairwiseCost (cpp:54-98): overlap
        of A's and B's template patches at their (possibly moved)
        positions, similarity of the label-deformed maps at A's patch
        vertices."""
        st, K = self.st, self.K
        rl, spac = state["rl"], state["spac"]
        a, b, ma, mb = rows[:, 1], rows[:, 2], rows[:, 3], rows[:, 4]
        part = partner[a, b]                                     # (b,K)
        cur_a = lab_sk[a]
        cur_b = torch.gather(lab_sk[b], 1, part)
        la2 = torch.stack([cur_a, torch.full_like(cur_a, alpha)], -1)
        lb2 = torch.stack([cur_b, torch.full_like(cur_b, alpha)], -1)

        a3 = self.a_slot[a][:, None, None]
        b3 = b[:, None, None]
        v3 = torch.arange(K, device=self.dev)[None, :, None]
        idx_a = state["p_idx"][a3, v3, la2]                      # (b,K,2,pmax)
        rng_a = state["p_rng"][a3, v3, la2]
        pos_b = rl[b3, part[:, :, None], lb2]                    # (b,K,2,3)

        ta = st.tmpl_coords[idx_a]                               # (b,K,2,pmax,3)
        chord = torch.linalg.norm(
            ta[:, :, :, None] - pos_b[:, :, None, :, None], dim=-1)
        lim_b = st.cprange * torch.gather(spac[b], 1, part)      # (b,K)
        rng_b = _geodesic_from_chord(chord) < lim_b[:, :, None, None, None]
        overlap = rng_a[:, :, :, None] & rng_b                   # (b,K,2,2,pmax)

        D = maps.shape[2]
        dd = torch.arange(D, device=self.dev)
        data_a = maps[ma[:, None, None, None, None], la2[:, :, :, None, None],
                      dd[None, None, None, :, None],
                      idx_a[:, :, :, None, :]]                   # (b,K,2,D,pmax)
        shape = (rows.shape[0], K, 2, 2, D, st.pmax)
        data_a4 = data_a[:, :, :, None].expand(shape)
        db_full = maps[mb[:, None, None, None, None, None],
                       lb2[:, :, None, :, None, None],
                       dd[None, None, None, None, :, None],
                       idx_a[:, :, :, None, None, :]]            # (b,K,2,2,D,pmax)
        if st.mask_w is not None:
            w = st.mask_w[idx_a][:, :, :, None, None, :].expand(shape)
        else:
            w = torch.ones((), dtype=maps.dtype, device=self.dev).expand(shape)
        m = overlap[:, :, :, :, None, :].expand(shape).to(maps.dtype)
        per_dim = simi.sim_for_min(data_a4, db_full, w, m, st.simval,
                                   st.percentile)                # (b,K,2,2,D)
        cost = per_dim.mean(-1)
        if st.fixnan:
            cost = torch.where(torch.isnan(cost),
                               torch.full_like(cost, FIX_NAN), cost)
        return cost.reshape(-1, K, 4)

    def _pair_tables(self, state, maps, partner, lab_sk, alpha):
        """This rank's pair blocks in their p4 slots, zeros elsewhere
        (B,K,4); under 'ring' the exchange steps happen here."""
        per_block = self.K * 4 * maps.shape[2] * self.st.pmax
        size = max(1, min(self.B, self.PAIR_CHUNK_ELEMS // per_block))
        p4 = torch.zeros((self.B, self.K, 4), dtype=maps.dtype,
                         device=self.dev)
        visiting = maps
        # batches of `size` blocks this call runs on this rank (read by
        # the driver's metrics)
        self.pair_chunk_blocks, self.pair_chunks = size, 0
        for r, rows in enumerate(self.plan):
            if self.maps_exchange == "ring" and r > 0:
                visiting = self.comm.ring_shift(visiting)
                window = torch.cat([maps, visiting])
            else:
                window = maps
            for s, e in _padded_chunks(rows.shape[0], size):
                self.pair_chunks += 1
                chunk = _pad_rows(rows[s:e], size)
                p4[rows[s:e, 0]] = self.pair_block_cost(
                    state, window, partner, lab_sk, alpha, chunk)[:e - s]
        return p4

    def build_tables_for(self, state, maps, partner, lab_sk, alpha):
        """(t8 (S*T,8), p4 (B*K,4)) of one alpha, equal on every rank."""
        t8 = self.triplet_block(state, lab_sk, alpha)
        p4 = self.comm.disjoint_sum(
            self._pair_tables(state, maps, partner, lab_sk, alpha))
        return t8.reshape(-1, 8), p4.reshape(-1, 4)

    def pair_endpoints(self, partner):
        a, b = self.blocks[:, 0], self.blocks[:, 1]
        K = self.K
        e0 = (a[:, None] * K + torch.arange(K, device=self.dev)[None])
        e1 = b[:, None] * K + partner[a, b]
        return torch.stack([e0.reshape(-1), e1.reshape(-1)], 1)   # (B*K,2)

    # ---- one alpha -------------------------------------------------------
    def starts_for(self, alpha: int):
        n, N = self.st.n_restarts, self.S * self.K
        if n == 0:
            return None
        if self.random_starts is not None:
            return self.random_starts(alpha)
        if alpha not in self._starts:
            if self.generator is None:
                raise ValueError("GroupFusion: a torch.Generator or "
                                 "random_starts is required for random "
                                 "restarts")
            self._starts[alpha] = torch.randint(0, 2, (n, N),
                                                generator=self.generator)
        return self._starts[alpha]

    def alpha_step(self, state, maps, partner, tables, pair_nodes, labeling,
                   alpha: int):
        st, N = self.st, self.S * self.K
        t8, p4 = self.build_tables_for(state, maps, partner,
                                       labeling.reshape(self.S, self.K), alpha)
        # greedy-data start: switch wherever the pair (similarity) term
        # alone prefers alpha at x=0, the group analogue of the single-pair
        # greedy-unary start (the group binary has no explicit unary, its
        # data term lives in the p4 pair blocks)
        ipr, pe = tables.vert_pair, tables.vert_pair_end
        ip_s = ipr.clamp(min=0)
        wp = torch.where(pe == 0, 2, 1)
        d_p = (p4[ip_s, wp] - p4[ip_s, 0]) * (ipr >= 0)
        greedy = (d_p.sum(1) < 0).to(torch.int64)
        x0 = torch.stack([torch.zeros(N, dtype=torch.int64, device=self.dev),
                          torch.ones(N, dtype=torch.int64, device=self.dev),
                          greedy])
        starts = self.starts_for(alpha)
        if starts is not None:
            if tuple(starts.shape) != (st.n_restarts, N):
                raise ValueError(f"GroupFusion: {st.n_restarts} random starts "
                                 f"of length {N} required")
            x0 = torch.cat([x0, starts.to(device=self.dev, dtype=torch.int64)])
        zero = torch.zeros(N, dtype=t8.dtype, device=self.dev)
        xs, es = icm.icm_binary(x0, zero, zero, t8, self.trip_nodes, tables,
                                st.icm_passes, p4, pair_nodes)
        x = xs[torch.argmin(es)]
        return torch.where(x == 1, torch.full_like(labeling, alpha), labeling)

    def energy(self, state, maps, partner, labeling):
        """Energy at the labeling: combo-0 ("keep all") sums of a fresh
        table build (the alpha value is irrelevant for combo 0)."""
        t8, p4 = self.build_tables_for(
            state, maps, partner, labeling.reshape(self.S, self.K), 0)
        return t8[:, 0].sum() + p4[:, 0].sum()

    def __call__(self, maps, cp, spac, labeling, partner, tables):
        state = self.prepare(cp, spac)
        if self.maps_exchange == "gather":
            maps = self.comm.all_gather(maps)
        pair_nodes = self.pair_endpoints(partner)
        for i in range(self.st.sweeps * self.L):
            with trace.mark("group.alpha"):
                labeling = self.alpha_step(state, maps, partner, tables,
                                           pair_nodes, labeling, i % self.L)
        return (labeling, self.energy(state, maps, partner, labeling),
                state["patch_need"])


def make_fusion_fn(st: GroupLevelStatics, S: int,
                   generator: Optional[torch.Generator] = None,
                   random_starts: Optional[Callable] = None,
                   comm: Optional[SubjectComm] = None,
                   maps_exchange: str = "gather") -> GroupFusion:
    """The fusion sweep of one level (see GroupFusion). Without `generator`
    and `random_starts`, the starts come from a generator seeded with
    FUSION_SEED. comm None: one rank."""
    if generator is None and random_starts is None:
        generator = torch.Generator().manual_seed(FUSION_SEED)
    return GroupFusion(st, S, generator, random_starts, comm, maps_exchange)


# --------------------------------------------------------------------------
# the apply stage
# --------------------------------------------------------------------------

def make_apply_fn(st: GroupLevelStatics, S: int, cp_mesh, dg_mesh,
                  comm: Optional[SubjectComm] = None):
    """Apply-labeling stage (the group driver's per-subject unfold +
    sphere_project_warp loop, group_mesh_registration.cpp:104-115).

    Call: (dg_coords (S/W,N,3), cp (S/W,K,3) of this rank's subjects,
           labeling (S*K,)) -> (dg_coords', cp', spac' (S/W,K))

    Per subject: CP_k <- R_k . label_{l_k} (applyLabeling), unfold the CP
    grid, warp the data-grid sphere through (old CP -> new CP), unfold it,
    and recompute the per-CP spacings (get_spacings). Each subject is
    computed alone and its unfold stops by its own fold count, so a
    subject's result does not depend on which others share the call, and
    each rank applies only its own subjects (the JAX package's
    apply_sharded=True; its default gathers all subjects on every rank,
    because there a subject-sharded apply compiles to other bits)."""
    from ..ops.resample import warp_coords
    from ..ops.unfold import UnfoldTopology, unfold_coords

    comm = comm or SubjectComm()
    dev = st.labels.device
    K = st.orig_cp.shape[0]
    cp_topo = UnfoldTopology.from_mesh(cp_mesh, dev)
    dg_topo = UnfoldTopology.from_mesh(dg_mesh, dev)
    nbr = cp_topo.nbr_idx
    nbr_ok = nbr >= 0
    nbr_c = nbr.clamp(0, K - 1)

    def one(dg_s, cp_s, lab_s):
        rots = sph.rodrigues(st.centre.expand(cp_s.shape), cp_s)
        rl = torch.einsum("kij,lj->kli", rots, st.labels)         # (K,L,3)
        moved = torch.gather(rl, 1, lab_s[:, None, None].expand(K, 1, 3))
        # the unfold of the JAX package's apply stage: fold count and the
        # 1000-sweep cap, no stall rule
        new_cp = unfold_coords(moved[:, 0], cp_topo, stall_break=False)[0]
        # the search must answer on the DEFORMED old grid
        frm = dataclasses.replace(st.cp_search, coords=cp_s,
                                  pristine_res=-1, descent=())
        warped = warp_coords(dg_s, frm, new_cp)
        warped = unfold_coords(warped, dg_topo, stall_break=False)[0]
        d = _geodesic_from_chord(torch.linalg.norm(
            new_cp[nbr_c] - new_cp[:, None, :], dim=2))
        return (warped, new_cp,
                torch.where(nbr_ok, d, torch.zeros_like(d)).max(dim=1).values)

    def apply(dg_coords, cp, labeling):
        lab_sk = labeling.reshape(S, K)
        first = comm.rank * cp.shape[0]
        # each subject's rows in an allocation of their own (make_maps_fn)
        outs = [one(dg_coords[i].clone(), cp[i].clone(), lab_sk[first + i])
                for i in range(cp.shape[0])]
        return tuple(torch.stack(x) for x in zip(*outs))

    return apply
