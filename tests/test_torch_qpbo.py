"""The port's fusion ICM certified by the JAX package's roof-duality
oracle (`newmsm_tpu.native._geometry.qpbo_binary`), as
tests/test_qpbo_oracle.py certifies the JAX package's.

Real binary subproblems of newmsm_tpu_torch on the CPU: every fusion move
of the pairwise driver's loop at K = 162 (CP ico-2 on an ico-4 sphere, 2
iterations x 2 sweeps x every label), with the triplet strain tables
(regoption 3, `binary_fast`) and with the pair tables (regoption 1); and
every alpha step of one group fusion sweep (3 subjects, the group
`GroupIterTables` over 126 nodes with their pair blocks). The tables (u0, u1,
t8, p4) are the port's `binary_move_tables` output, or the group's
`build_tables_for`, fed to the oracle in float64.

Contract (tests/test_qpbo_oracle.py:1-35): where the oracle labels every
node (a certified global optimum), the ICM energy equals it; where it
labels some, grafting its persistent labels onto the ICM solution must not
lower the energy (else ICM missed a certified improving move). Every
move's ICM call is also replayed through the JAX package's `_binary_icm`
from the same starts on the same float32 tables: the port's solution costs
what the JAX package's does, so a gap the oracle finds belongs to the
shared algorithm, not to the port.

On the triplet path (the main path) the contract holds at 1e-4 relative
on every move, as in the JAX package's test. On the pair path and the
group path it does not, in either package: 2 of 76 pair moves end 1.4e-4
and 1.6e-4 relative above the certified optimum, and 2 of 19 group steps
leave 4.5e-4 and 6.1e-4 relative to a certified graft (the greedy start
closes every gap on triplets only). ROADMAP queue 3 records this fault;
those two paths are held at 1e-3 relative until it is fixed, so that a
larger gap still fails. The port has no compiled extension: this test
skips when the JAX package's does not import.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newmsm_tpu.reg.optimise import fusion as JFU

from newmsm_tpu_torch import convert
from newmsm_tpu_torch.core.mesh import Mesh
from newmsm_tpu_torch.ops import icm
from newmsm_tpu_torch.parallel import group_fusion as TGF
from newmsm_tpu_torch.reg import model as TM
from newmsm_tpu_torch.reg.optimise import fusion as FU

from fixtures import smooth_pattern

G = pytest.importorskip("newmsm_tpu.native._geometry")

torch.set_num_threads(2)


def _oracle(u0, u1, t8, triplets, p4, pairs):
    return G.qpbo_binary(
        np.asarray(u0, np.float64), np.asarray(u1, np.float64),
        np.asarray(triplets, np.int32).reshape(-1, 3),
        np.asarray(t8, np.float64).reshape(-1, 8),
        np.asarray(pairs, np.int32).reshape(-1, 2),
        np.asarray(p4, np.float64).reshape(-1, 4))


def _energy_np(x, u0, u1, t8, triplets, p4, pairs):
    x = x.astype(np.int64)
    e = np.where(x == 1, u1, u0).sum()
    if len(triplets):
        xb = x[triplets]
        e += t8[np.arange(len(triplets)),
                xb[:, 0] * 4 + xb[:, 1] * 2 + xb[:, 2]].sum()
    if len(pairs):
        xp = x[pairs]
        e += p4[np.arange(len(pairs)), xp[:, 0] * 2 + xp[:, 1]].sum()
    return float(e)


def _as_np(t, shape):
    return (np.zeros(shape) if t is None
            else t.detach().double().numpy())


@contextlib.contextmanager
def icm_calls():
    """Record the inputs of every call of the port's `_binary_icm` (the
    starts before the descent overwrites them)."""
    calls = []
    orig = icm._binary_icm

    def spy(x, u0, u1, t8, triplets, tables, icm_passes, p4=None,
            pairs=None):
        calls.append(dict(x0=x.clone(), u0=u0, u1=u1, t8=t8, p4=p4,
                          triplets=triplets, pairs=pairs, tables=tables,
                          passes=icm_passes))
        return orig(x, u0, u1, t8, triplets, tables, icm_passes, p4, pairs)

    icm._binary_icm = spy
    try:
        yield calls
    finally:
        icm._binary_icm = orig


@functools.partial(jax.jit, static_argnames="passes")
def _jax_solve(x0, u0, u1, t8, p4, trip, pairs, ft, passes):
    xs = jax.vmap(lambda x: JFU._binary_icm(
        x, u0, u1, t8, p4, trip, pairs, ft, passes))(x0)
    es = jax.vmap(lambda x: JFU.binary_energy(x, u0, u1, t8, p4, trip,
                                              pairs))(xs)
    return xs[jnp.argmin(es)]


def jax_icm(call):
    """The JAX package's multi-start ICM (fusion_binary_solve's vmap and
    first-minimum choice) from the starts and float32 tables of one of the
    port's calls; its solution."""
    tab = call["tables"]
    groups = [g.numpy() for g in tab.groups]
    width = max(len(g) for g in groups)
    vgroups = np.full((len(groups), width), -1, np.int32)
    for c, g in enumerate(groups):
        vgroups[c, :len(g)] = g

    def j(t, dtype=jnp.int32):
        return None if t is None else jnp.asarray(t.numpy(), dtype)

    ft = JFU.FusionTables(
        vgroups=jnp.asarray(vgroups), vgroup_mask=jnp.asarray(vgroups >= 0),
        vert_tri=j(tab.vert_tri), vert_tri_corner=j(tab.vert_tri_corner),
        vert_pair=j(tab.vert_pair), vert_pair_end=j(tab.vert_pair_end))
    u0, u1 = j(call["u0"], jnp.float32), j(call["u1"], jnp.float32)
    t8, p4 = j(call["t8"], jnp.float32), j(call["p4"], jnp.float32)
    trip, pairs = j(call["triplets"]), j(call["pairs"])
    if t8 is None or trip.shape[0] == 0:
        t8, trip = None, jnp.zeros((0, 3), jnp.int32)
    return np.asarray(_jax_solve(j(call["x0"]), u0, u1, t8, p4, trip, pairs,
                                 ft, passes=call["passes"]))


def _certify(moves, rel):
    """Hold every move to the oracle at `rel` relative, and to the JAX
    package's ICM; returns (moves, fully labelled, moves with a gap above
    1e-4 relative, largest relative gap)."""
    n = n_exact = n_gap = 0
    worst = 0.0
    for x, e_port, tabs, call in moves:
        u0, u1, t8, trip, p4, pairs = tabs
        x = x.numpy()
        e_icm = _energy_np(x, *tabs)
        scale = max(1.0, abs(e_icm))
        # the port's own float32 energy of its solution, and the JAX
        # package's solution from the same starts
        assert abs(e_port - e_icm) <= 1e-4 * scale, (n, e_port, e_icm)
        e_jax = _energy_np(jax_icm(call), *tabs)
        assert abs(e_jax - e_icm) <= 1e-5 * scale, (n, e_jax, e_icm)
        lab, lb, nunl = _oracle(u0, u1, t8, trip, p4, pairs)
        assert lb <= e_icm + 1e-4 * scale, (n, lb, e_icm)
        n += 1
        if nunl == 0:
            n_exact += 1
            gap = e_icm - _energy_np(lab, *tabs)
        else:
            filled = x.copy()
            filled[lab >= 0] = lab[lab >= 0]
            gap = e_icm - _energy_np(filled, *tabs)
        worst = max(worst, gap / scale)
        n_gap += gap > 1e-4 * scale
        assert gap <= rel * scale, (n, nunl, e_icm, gap)
    return n, n_exact, n_gap, worst


def pairwise_moves(regmode, outers=2, sweeps=2, cp_res=2, target_res=4):
    """The pairwise driver's fusion loop on the port's PairwiseModel: per
    iteration the set-up, the unary volume and every binary move of
    `sweeps` sweeps (the driver's starts: a generator seeded 7, 2 random
    starts an alpha), then apply_labeling. Yields (ICM x, the port's
    float32 binary energy, float64 tables)."""
    target = Mesh.from_icosphere(target_res)
    target.true_rescale(100.0)
    control = Mesh.from_icosphere(cp_res)
    control.true_rescale(100.0)
    cfg = TM.ModelConfig(simval=2, reglambda=0.1, sg_res=cp_res + 2,
                         regmode=regmode)
    model = TM.PairwiseModel(
        cfg, control, target.copy(), target,
        smooth_pattern(target.coords, seed=3)[None],
        smooth_pattern(target.coords, seed=4)[None], device="cpu")
    K = control.nvertices
    cfw = np.ones((1, target.nvertices))
    for _ in range(outers):
        s = model.setup_iteration(cfw)
        L = model.num_labels
        unary = model.unary(s).T                        # (L,K)
        if model.pairwise_mode:
            pairs = model.tables.pairs
            triplets = pairs.new_zeros((0, 3))
            pfn, tfn = model.pair_combo_fn(s), None
        else:
            pairs, pfn = None, None
            triplets = model.tables.triplets
            tfn = model.triplet_combo_fn(s)
        gen = torch.Generator().manual_seed(7)
        starts = {a: torch.randint(0, 2, (2, K), generator=gen)
                  for a in range(L)}
        labeling = torch.zeros(K, dtype=torch.int64)
        for _ in range(sweeps):
            for alpha in range(L):
                with icm_calls() as calls:
                    x = FU.fusion_binary_solve(
                        labeling, alpha, unary, triplets,
                        model.fusion_tables, tfn, starts=starts[alpha],
                        pairs=pairs, pair_combo_fn=pfn)
                u0, u1, t8, p4 = FU.binary_move_tables(
                    labeling, alpha, unary, triplets, tfn, pairs, pfn)
                e = float(icm.binary_energy(x, u0, u1, t8, triplets, p4,
                                           pairs))
                yield x, e, (
                    u0.double().numpy(), u1.double().numpy(),
                    _as_np(t8, (0, 8)), triplets.numpy(),
                    _as_np(p4, (0, 4)),
                    np.zeros((0, 2)) if pairs is None else pairs.numpy()
                ), calls[0]
                labeling = torch.where(x == 1, torch.full_like(
                    labeling, alpha), labeling)
        model.apply_labeling(labeling.numpy(), s)


@pytest.mark.parametrize("regmode,rel", [(3, 1e-4), (1, 1e-3)],
                         ids=["triplets", "pairs"])
def test_pairwise_icm_is_certified_at_K162(regmode, rel):
    """Every move of 2 iterations x 2 sweeps x every label at K = 162:
    regoption 3 (strain triplets, FOLDING-gated, t8; the contract at 1e-4)
    and regoption 1 (the rotation-difference pairs, p4; the queue-3 fault,
    held at 1e-3)."""
    n, n_exact, n_gap, worst = _certify(pairwise_moves(regmode), rel)
    print(f"regoption {regmode}: {n} moves, oracle fully labelled "
          f"{n_exact}, {n_gap} with a gap above 1e-4 relative, largest "
          f"{worst:.3e}")
    assert n == 2 * 2 * 19
    if regmode == 3:
        assert n_gap == 0


def group_moves(S=3):
    """One group fusion sweep on test_torch_group.build_problem(3, seed=5)
    (warped CP ico-1 grids, ico-3 template, random labeling), all in the
    port: the partner map, the iteration tables, then per alpha the (t8,
    p4) tables and GroupFusion.alpha_step. The step returns labels, not its
    binary x: x = (new label == alpha), which costs the same as the ICM's x
    (a node already at alpha has equal keep and switch entries)."""
    from test_torch_group import build_problem
    p = build_problem(S, seed=5)
    K, L = p["K"], p["L"]
    cp = convert.tensor(p["cp"], "cpu")
    partner = TGF.make_partner_fn(p["tst"], S)(cp)
    tables = TGF.build_iteration_tables(partner.numpy(), p["trip"], S, K,
                                        "cpu")
    fusion = TGF.make_fusion_fn(p["tst"]._replace(sweeps=1), S)
    maps = convert.tensor(p["maps"], "cpu")
    state = fusion.prepare(cp, convert.tensor(p["spac"], "cpu"))
    pair_nodes = fusion.pair_endpoints(partner)
    trip = fusion.trip_nodes
    labeling = torch.from_numpy(
        np.random.default_rng(9).integers(0, L, S * K))
    zero = np.zeros(S * K)
    for alpha in range(L):
        t8, p4 = fusion.build_tables_for(state, maps, partner,
                                         labeling.reshape(S, K), alpha)
        with icm_calls() as calls:
            new = fusion.alpha_step(state, maps, partner, tables,
                                    pair_nodes, labeling, alpha)
        x = (new == alpha).to(torch.int64)
        e = float(icm.binary_energy(x, torch.zeros(S * K), torch.zeros(S * K),
                                   t8, trip, p4, pair_nodes))
        yield x, e, (zero, zero, t8.double().numpy(), trip.numpy(),
                     p4.double().numpy(), pair_nodes.numpy()), calls[0]
        labeling = new


def test_group_icm_is_certified():
    """Every alpha step of one group sweep (126 nodes, 3 pair blocks): the
    queue-3 fault, held at 1e-3."""
    n, n_exact, n_gap, worst = _certify(group_moves(), 1e-3)
    print(f"group: {n} moves, oracle fully labelled {n_exact}, {n_gap} with "
          f"a gap above 1e-4 relative, largest {worst:.3e}")
    assert n == 19
