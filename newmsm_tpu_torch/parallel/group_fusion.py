"""The groupwise fusion optimiser on one device.

Port of newmsm_tpu/parallel/group_fusion.py: the fusion-move sweep of
Fusion::optimize (Fusion.h:122-244) on the DiscreteGroupModel energy
(DiscreteGroupCostFunction.cpp:26-98), with all S subjects batched on one
device:

  - label-deformed template maps (get_patch_data, DiscreteGroupModel.cpp:
    88-121), subject by subject through ops.resample.label_deformed_maps;
  - cross-subject CP correspondences (estimate_pairs,
    DiscreteGroupModel.cpp:37-55) on the DEFORMED CP grids;
  - per fusion alpha step, the binary move tables of every subject's
    triplets and of every (a,b) pair block in one batch, then the binary
    ICM solve of reg/optimise/fusion.py over conflict-free colour groups,
    multi-start like the pairwise solver.

A pair block's template patch depends on (subject, CP, label) only, not on
alpha or on the partner, so the patches of all (subject, CP, label) are
built once per fusion call and every alpha step gathers from them; the JAX
package recomputes them inside each alpha step (one fused XLA program).
The values are the same.

Across devices nothing is ported here: the slot tables, the ring exchange
of the maps tensor and the sharded apply stage of the JAX package only have
meaning on a device mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import FIX_NAN, FOLDING, RAD, resolve_device
from ..core import spherical as sph
from ..ops import similarity as simi
from ..ops.nearest import SearchTables, _search
from ..ops.strain import triangular_strain
from ..reg.optimise import fusion as FU

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
    sizes and the colour groups are a tuple of id tensors."""
    groups: tuple                   # per colour, the (G_c,) node ids
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
        return hit

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

    out = GroupIterTables(
        groups=tuple(put(np.nonzero(colors == c)[0])
                     for c in range(int(colors.max()) + 1)),
        vert_tri=put(vert_tri), vert_tri_corner=put(vert_tri_corner),
        vert_pair=put(vert_pair), vert_pair_end=put(vert_pair_end),
        colors=colors)
    if len(_ITER_TABLE_CACHE) >= _ITER_TABLE_CACHE_MAX:
        _ITER_TABLE_CACHE.pop(next(iter(_ITER_TABLE_CACHE)))
    _ITER_TABLE_CACHE[key] = out
    return out


# --------------------------------------------------------------------------
# partner map (estimate_pairs)
# --------------------------------------------------------------------------

def make_partner_fn(st: GroupLevelStatics, S: int):
    """cp (S,K,3) -> partner (S,S,K) int64: partner[a,b,v] = closest CP
    vertex in subject b's grid to subject a's CP v (get_closest_vertex_ID
    through the deformed grids, DiscreteGroupModel.cpp:37-55)."""

    def run(cp):
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
    """(dg_coords (S,N,3), dg_data (S,D,N)) -> maps (S,L,D,Nt)."""
    from ..ops.resample import label_deformed_maps
    dg_faces, dg_tri_idx, dg_ring_faces, dg_ring_verts, tmpl_tables, \
        tmpl_vareas = dg_topology

    def run(dg_coords, dg_data):
        return torch.stack([
            label_deformed_maps(c, d, dg_faces, dg_tri_idx, dg_ring_faces,
                                dg_ring_verts, st.labels, st.centre,
                                tmpl_tables, tmpl_vareas, cap=cap)
            for c, d in zip(dg_coords, dg_data)])

    return run


# --------------------------------------------------------------------------
# the fusion optimisation step
# --------------------------------------------------------------------------

def _geodesic_from_chord(chord):
    return 2.0 * RAD * torch.arcsin((chord / (2 * RAD)).clamp(-1, 1))


class _IcmTables:
    """Adapter: GroupIterTables -> the FusionTables attribute surface that
    reg/optimise/fusion._binary_icm consumes."""

    def __init__(self, t: GroupIterTables):
        self.groups = t.groups
        self.vert_tri = t.vert_tri
        self.vert_tri_corner = t.vert_tri_corner
        self.vert_pair = t.vert_pair
        self.vert_pair_end = t.vert_pair_end


class GroupFusion:
    """The fusion sweep of one level. Call:

        (maps (S,L,D,Nt), cp (S,K,3), spac (S,K), labeling (S*K,) int64,
         partner (S,S,K) int64, tables: GroupIterTables)
          -> (labeling (S*K,), energy (), patch_need ())

    patch_need is the MAX in-range template-vertex count over all (CP,
    label) patch requests; above st.pmax means patches were truncated and
    the caller must grow pmax to this and redo.

    The stages are methods so that the tests can hold each against the JAX
    package from identical state: `prepare` (label positions and patches of
    one call), `build_tables_for` (one alpha's binary tables), `alpha_step`.

    Random starts: `random_starts(alpha)` -> (n_restarts, S*K) int tensor
    when given, else drawn from `generator` once per alpha and kept, so an
    alpha's starts are the same in every sweep and iteration (as the JAX
    package's, which folds alpha into a fixed key)."""

    # rows of one patch-distance chunk: (rows, Nt) float32 each
    PATCH_CHUNK_ELEMS = 1 << 26
    # elements of one pair-block batch: (blocks, K, 2, 2, D, pmax)
    PAIR_CHUNK_ELEMS = 1 << 26

    def __init__(self, st: GroupLevelStatics, S: int,
                 generator: Optional[torch.Generator] = None,
                 random_starts: Optional[Callable] = None):
        self.st = st
        self.S = S
        self.K = st.orig_cp.shape[0]
        self.L = st.labels.shape[0]
        self.T = st.cp_faces.shape[0]
        self.dev = st.labels.device
        self.blocks = torch.from_numpy(
            pair_blocks(S).astype(np.int64)).to(self.dev)
        self.B = self.blocks.shape[0]
        self.generator = generator
        self.random_starts = random_starts
        self._starts: dict = {}
        self.trip_nodes = (st.cp_faces[None] + (torch.arange(
            S, device=self.dev) * self.K)[:, None, None]).reshape(-1, 3)

    # ---- per-call state --------------------------------------------------
    def patch_of(self, pos, limit):
        """pos (R,3), limit (R,) -> (idx (R,pmax), in_range (R,pmax) bool,
        n_inrange (R,) count of template vertices within `limit`, which
        detects silent top-k truncation against st.pmax)."""
        st = self.st
        tmpl = st.tmpl_coords
        tsq = (tmpl ** 2).sum(1)
        rows = max(1, self.PATCH_CHUNK_ELEMS // tmpl.shape[0])
        idx, rng, n_in = [], [], []
        for s in range(0, pos.shape[0], rows):
            p, lim = pos[s:s + rows], limit[s:s + rows]
            d2 = tsq - 2.0 * (p @ tmpl.T) + (p * p).sum(-1)[:, None]
            dist = _geodesic_from_chord(torch.sqrt(d2.clamp(min=0.0)))
            n_in.append((dist < lim[:, None]).sum(-1))
            near, ix = torch.topk(dist, st.pmax, dim=-1, largest=False)
            idx.append(ix)
            rng.append(near < lim[:, None])
        return torch.cat(idx), torch.cat(rng), torch.cat(n_in)

    def prepare(self, cp, spac):
        """The label positions rl (S,K,L,3) of this call and the template
        patch of every (a, CP, label) a pair block can ask for: a runs over
        the first subjects of the blocks, 0..S-2. Returns a dict."""
        st, S, K, L = self.st, self.S, self.K, self.L
        rots = sph.rodrigues(st.centre.expand(cp.shape), cp)
        rl = torch.einsum("skij,lj->skli", rots, st.labels)      # (S,K,L,3)
        lim = (st.cprange * spac[:S - 1])[:, :, None].expand(S - 1, K, L)
        idx, rng, n_in = self.patch_of(rl[:S - 1].reshape(-1, 3),
                                       lim.reshape(-1))
        return dict(rl=rl, cp=cp, spac=spac,
                    p_idx=idx.reshape(S - 1, K, L, st.pmax),
                    p_rng=rng.reshape(S - 1, K, L, st.pmax),
                    patch_need=n_in.max())

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

    def pair_block_cost(self, state, maps, partner, lab_sk, alpha, blocks):
        """(b,K,4) binary pair tables of the blocks `blocks` (b,2), a<b:
        combos indexed x_a*2 + x_b, x=1 means switch to alpha. Reproduces
        DiscreteGroupCostFunction::computePairwiseCost (cpp:54-98): overlap
        of A's and B's template patches at their (possibly moved)
        positions, similarity of the label-deformed maps at A's patch
        vertices."""
        st, K = self.st, self.K
        rl, spac = state["rl"], state["spac"]
        a, b = blocks[:, 0], blocks[:, 1]
        part = partner[a, b]                                     # (b,K)
        cur_a = lab_sk[a]
        cur_b = torch.gather(lab_sk[b], 1, part)
        la2 = torch.stack([cur_a, torch.full_like(cur_a, alpha)], -1)
        lb2 = torch.stack([cur_b, torch.full_like(cur_b, alpha)], -1)

        a3 = a[:, None, None]
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
        data_a = maps[a[:, None, None, None, None], la2[:, :, :, None, None],
                      dd[None, None, None, :, None],
                      idx_a[:, :, :, None, :]]                   # (b,K,2,D,pmax)
        shape = (blocks.shape[0], K, 2, 2, D, st.pmax)
        data_a4 = data_a[:, :, :, None].expand(shape)
        db_full = maps[b[:, None, None, None, None, None],
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

    def build_tables_for(self, state, maps, partner, lab_sk, alpha):
        """(t8 (S*T,8), p4 (B*K,4)) of one alpha."""
        t8 = self.triplet_block(state, lab_sk, alpha).reshape(-1, 8)
        per_block = self.K * 4 * maps.shape[2] * self.st.pmax
        step = max(1, self.PAIR_CHUNK_ELEMS // per_block)
        p4 = torch.cat([
            self.pair_block_cost(state, maps, partner, lab_sk, alpha,
                                 self.blocks[s:s + step])
            for s in range(0, self.B, step)])
        return t8, p4.reshape(-1, 4)

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
        xs = FU._binary_icm(x0, zero, zero, t8, self.trip_nodes,
                            _IcmTables(tables), st.icm_passes, p4, pair_nodes)
        es = FU.binary_energy(xs, zero, zero, t8, self.trip_nodes, p4,
                              pair_nodes)
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
        pair_nodes = self.pair_endpoints(partner)
        for i in range(self.st.sweeps * self.L):
            labeling = self.alpha_step(state, maps, partner, tables,
                                       pair_nodes, labeling, i % self.L)
        return (labeling, self.energy(state, maps, partner, labeling),
                state["patch_need"])


def make_fusion_fn(st: GroupLevelStatics, S: int,
                   generator: Optional[torch.Generator] = None,
                   random_starts: Optional[Callable] = None) -> GroupFusion:
    """The fusion sweep of one level (see GroupFusion). Without `generator`
    and `random_starts`, the starts come from a generator seeded with
    FUSION_SEED."""
    if generator is None and random_starts is None:
        generator = torch.Generator().manual_seed(FUSION_SEED)
    return GroupFusion(st, S, generator, random_starts)


# --------------------------------------------------------------------------
# the apply stage
# --------------------------------------------------------------------------

def make_apply_fn(st: GroupLevelStatics, S: int, cp_mesh, dg_mesh):
    """Apply-labeling stage (the group driver's per-subject unfold +
    sphere_project_warp loop, group_mesh_registration.cpp:104-115).

    Call: (dg_coords (S,N,3), cp (S,K,3), labeling (S*K,))
      -> (dg_coords', cp', spac' (S,K))

    Per subject: CP_k <- R_k . label_{l_k} (applyLabeling), unfold the CP
    grid, warp the data-grid sphere through (old CP -> new CP), unfold it,
    and recompute the per-CP spacings (get_spacings). Each subject's unfold
    stops by its own fold count, so results do not depend on S."""
    from ..ops.resample import warp_coords
    from ..ops.unfold import UnfoldTopology, unfold_coords

    dev = st.labels.device
    K = st.orig_cp.shape[0]
    cp_topo = UnfoldTopology.from_mesh(cp_mesh, dev)
    dg_topo = UnfoldTopology.from_mesh(dg_mesh, dev)
    nbr = cp_topo.nbr_idx
    nbr_ok = nbr >= 0
    nbr_c = nbr.clamp(0, K - 1)

    def apply(dg_coords, cp, labeling):
        lab_sk = labeling.reshape(S, K)
        rots = sph.rodrigues(st.centre.expand(cp.shape), cp)
        rl = torch.einsum("skij,lj->skli", rots, st.labels)      # (S,K,L,3)
        moved = torch.gather(
            rl, 2, lab_sk[:, :, None, None].expand(S, K, 1, 3))[:, :, 0]
        dg_out, cp_out, spac_out = [], [], []
        for s in range(S):
            # the unfold of the JAX package's apply stage: fold count and
            # the 1000-sweep cap, no stall rule
            new_cp = unfold_coords(moved[s], cp_topo, stall_break=False)[0]
            # the search must answer on the DEFORMED old grid
            frm = dataclasses.replace(st.cp_search, coords=cp[s],
                                      pristine_res=-1, descent=())
            warped = warp_coords(dg_coords[s], frm, new_cp)
            warped = unfold_coords(warped, dg_topo, stall_break=False)[0]
            chord = torch.linalg.norm(new_cp[nbr_c] - new_cp[:, None, :],
                                      dim=2)
            d = _geodesic_from_chord(chord)
            spac_out.append(torch.where(nbr_ok, d, torch.zeros_like(d))
                            .max(dim=1).values)
            dg_out.append(warped)
            cp_out.append(new_cp)
        return torch.stack(dg_out), torch.stack(cp_out), torch.stack(spac_out)

    return apply
