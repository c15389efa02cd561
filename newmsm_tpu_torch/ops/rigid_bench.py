"""Rigid-cost problems at AFFINE's shapes, the comparison of K3
(csrc/rigid_cost.cu) with its plain version, and their times on the card
beside the bound of the call's work. chip_smoke.py and
tests/test_torch_cuda.py build their problems here.

A problem is the argument tuple of ops.rigid.rigid_terms: (rot,
src_data_c, tgt_coords, tgt_data_c, cos_ang, min_sigma, simval). The
target is the ico-`res` sphere at RAD with D smooth data channels; the
source the same sphere turned by `degrees` about a fixed axis, with the
target's fields sampled where it was before the turn plus noise, so the
turn is what AFFINE would undo. cos_ang and min_sigma are what
reg/rigid.py::rigid_align derives from the sphere's mean vertex distance.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import RAD
from ..core import spherical as sph
from ..core.mesh import Mesh
from ..reg import rigid as _reg_rigid
from . import rigid
from .locate_bench import PEAK_BYTES_PER_S, PEAK_FP32_FLOPS, time_launches

# operations counted for the bound (a multiply, an add, a compare, a
# division, a square root or an exponential is one): a gate is a 3-term dot
# and a compare; a pair in the neighbourhood the tangent-plane offsets
# (3 differences, two 3-term dots), dist2, the weight's exponent and
# exponential, the similarity beside its D-term dot, and the two sums; a
# source its normalisation, tangent basis and data norm beside its
# D-term sum of squares
GATE_OPS = 6
PAIR_OPS = 27
SOURCE_OPS = 40
# K3 against the plain version. A source's jp is a ratio of float32 sums
# over its ~60 neighbours, taken in another order (the plain version's
# dot products are cuBLAS's): within JP_RTOL of max(1, max |jp|). The
# totals agree to TOTAL_RTOL of the sum of |jp|, the float32 rounding of a
# sum of 10^4 terms in another order. A target whose unit dot with a
# source, as the plain version takes it, lies within GATE_ULPS float32
# ulps of cos_ang (a gate tie) can pass the gate in one and not in the
# other. A source beyond JP_RTOL is accepted only as a tie: it has at most
# MAX_GATE_TIES such targets, and K3's jp is, within JP_RTOL, the jp of the
# plain version's gate with some of them moved across it (in float64);
# the total is then held to the plain version's with those jp in place of
# its own. Any other source beyond JP_RTOL fails the comparison.
JP_RTOL = 2e-5
TOTAL_RTOL = 1e-5
GATE_ULPS = 8
MAX_GATE_TIES = 10
# device-side sleep a timed window queues behind (clocks; 1 ms at the
# H100's 1,980 MHz a launch of the window, above the host's cost of one)
HOLD_CYCLES_A_LAUNCH = 2_000_000


def _fields(unit: np.ndarray, channels: int, seed: int) -> np.ndarray:
    """(channels, N) smooth fields at unit directions: sums of 12 random
    plane-wave sinusoids a channel."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(channels, 12, 3)) * 3.0
    phase = rng.uniform(0, 2 * np.pi, (channels, 12))
    amp = rng.normal(size=(channels, 12))
    waves = np.sin(np.einsum("dtk,nk->dtn", k, unit) + phase[..., None])
    return (amp[..., None] * waves).sum(1)


def _rotation(degrees: float) -> np.ndarray:
    axis = np.array([0.3, 1.0, 0.2]) / np.linalg.norm([0.3, 1.0, 0.2])
    t = np.radians(degrees)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(t) * K + (1 - np.cos(t)) * K @ K


def problem(res: int = 5, channels: int = 2, simval: int = 2, device="cuda",
            seed: int = 0, degrees: float = 10.0, n_src: int | None = None,
            northern_targets: bool = False,
            zero_columns: bool = False) -> tuple:
    """A rigid-cost problem at ico-`res`. `degrees` 0 puts every source on
    a target (dist2 == 0 left out); `n_src` keeps the first n_src sources;
    `northern_targets` keeps the targets with z > 0, so the southern
    sources have empty neighbourhoods (wsum == 0); `zero_columns` zeroes
    every 7th source and every 5th target data column (cosine denominator
    0)."""
    sphere = Mesh.from_icosphere(res)
    mvd = sphere.calculate_MeanVD()
    tgt = sphere.coords
    unit = tgt / RAD
    R = _rotation(degrees)
    src = tgt @ R.T
    rng = np.random.default_rng((seed, 1))
    tgt_data = _fields(unit, channels, seed)
    src_data = _fields(unit @ R, channels, seed) + 0.3 * rng.normal(
        size=tgt_data.shape)
    if n_src is not None:
        src, src_data = src[:n_src], src_data[:, :n_src]
    if northern_targets:
        keep = tgt[:, 2] > 0
        tgt, tgt_data = tgt[keep], tgt_data[:, keep]
    src_c = _reg_rigid._center_columns(src_data)
    tgt_c = _reg_rigid._center_columns(tgt_data)
    if zero_columns:
        src_c[:, ::7] = 0.0
        tgt_c[:, ::5] = 0.0
    dev = torch.device(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    cos_ang = float(np.float32(np.cos(2 * np.arcsin(4 * mvd / (2 * RAD)))))
    return (put(src), put(src_c), put(tgt), put(tgt_c), cos_ang,
            float(np.float32(mvd)), simval)


def kernel(p) -> tuple:
    """One call of K3: (total 0-d, jp (N,))."""
    return rigid.rigid_terms(*p)


def neighbourhood_pairs(p, chunk: int = 2048) -> int:
    """Source-target pairs through the gate (the twin's own products)."""
    rot, _, tgt, _, cos_ang, _, _ = p
    tgt_unit = tgt / torch.linalg.norm(tgt, dim=1, keepdim=True)
    n = 0
    for s in range(0, rot.shape[0], chunk):
        rc = rot[s:s + chunk]
        unit = rc / torch.linalg.norm(rc, dim=1, keepdim=True)
        n += int(((unit @ tgt_unit.T) >= cos_ang).sum())
    return n


def bound(p, pairs: int) -> dict:
    """The least time of the call's work on the card: operations at the
    FP32 peak (the gates of every source-target pair, the work of the
    pairs through the gate and of every source) against the bytes read
    once and written once at the HBM peak."""
    rot, src, tgt, _, _, _, _ = p
    n, nt, d = rot.shape[0], tgt.shape[0], src.shape[0]
    ops = (n * nt * GATE_OPS + pairs * (PAIR_OPS + 2 * d)
           + n * (SOURCE_OPS + 2 * d))
    nbytes = 4 * ((3 + d) * (n + nt) + n + 1)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {"ops": ops, "bytes": nbytes, "gates": n * nt, "pairs": pairs,
            "bound_ms": 1e3 * max(t_ops, t_bytes), "bytes_ms": 1e3 * t_bytes,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _jp_across_the_gate(p, i: int, core: np.ndarray,
                        edge: np.ndarray) -> np.ndarray:
    """Source i's jp in float64 for every gate made of the targets `core`
    and a subset of the targets `edge` (boolean (Nt,) masks): (2^k,) for k
    edge targets, subset s holding edge target m where bit m of s is
    set."""
    rot, src, tgt, tdat, _, sigma, simval = (
        t.detach().double().cpu() if torch.is_tensor(t) else t for t in p)
    rc = rot[i]
    unit = rc / torch.linalg.norm(rc)
    e1, e2 = (e.numpy() for e in sph.vertex_tangent_basis(unit[None]))
    tgt, tdat, a = tgt.numpy(), tdat.numpy(), src[:, i].numpy()
    diff = tgt - rc.numpy()
    dist2 = (diff @ e1[0]) ** 2 + (diff @ e2[0]) ** 2
    w = np.where(dist2 > 0, np.exp(-dist2 / (2.0 * sigma * sigma)), 0.0)
    ab = a @ tdat
    if simval == 1:
        simm = -np.sqrt(np.maximum(a @ a + (tdat * tdat).sum(0) - 2 * ab,
                                   0.0)) / a.shape[0]
    else:
        denom = np.linalg.norm(a) * np.linalg.norm(tdat, axis=0)
        simm = np.where(denom > 0, ab / np.where(denom > 0, denom, 1.0), 0.0)
    idx = np.flatnonzero(edge)
    out = np.empty(1 << idx.size)
    for s in range(out.size):
        gate = core.copy()
        gate[[j for m, j in enumerate(idx) if s >> m & 1]] = True
        wsum = w[gate].sum()
        out[s] = (w[gate] * simm[gate]).sum() / wsum if wsum > 0 else 0.0
    return out


def compare(p) -> dict:
    """K3 against the plain version on one problem, with the tolerances
    above: the largest jp gap of the sources within JP_RTOL, in units of
    max(1, max |jp|); the gate ties (`ties`) and the sources beyond
    JP_RTOL that no gate tie explains (`unexplained`); the totals' gap
    over the sum of |jp|, the ties' jp in the plain version's total taken
    from the gate K3 matched; sources with jp 0 in each; whether two
    calls repeat each other bit for bit; and `ok`, all of it within the
    tolerances."""
    tk, jk = kernel(p)
    tk2, jk2 = kernel(p)
    tt, jt = rigid.rigid_terms_twin(*p)
    jk64, jt64 = jk.double().cpu().numpy(), jt.double().cpu().numpy()
    gap = np.abs(jk64 - jt64)
    unit = max(1.0, float(np.abs(jt64).max()))
    beyond = np.flatnonzero(gap > JP_RTOL * unit)
    rot, _, tgt, _, cos_ang, _, _ = p
    tol = GATE_ULPS * float(np.spacing(np.float32(cos_ang)))
    tgt_unit = tgt / torch.linalg.norm(tgt, dim=1, keepdim=True)
    moved, unexplained = 0.0, 0
    for s in range(0, beyond.size, 2048):
        rows = torch.as_tensor(beyond[s:s + 2048], device=rot.device)
        rc = rot[rows]
        dots = ((rc / torch.linalg.norm(rc, dim=1, keepdim=True))
                @ tgt_unit.T).cpu().numpy()
        for i, d in zip(beyond[s:s + 2048], dots):
            edge = np.abs(d.astype(np.float64) - cos_ang) <= tol
            if not 0 < edge.sum() <= MAX_GATE_TIES:
                unexplained += 1
                continue
            jps = _jp_across_the_gate(p, int(i), (d >= cos_ang) & ~edge, edge)
            best = jps[np.argmin(np.abs(jps - jk64[i]))]
            if abs(best - jk64[i]) > JP_RTOL * unit:
                unexplained += 1
            else:
                moved += best - jt64[i]
    scale = max(float(np.abs(jt64).sum()), 1e-30)
    total_gap = abs(float(tk) - (float(tt) + moved)) / scale
    within = np.ones(gap.size, bool)
    within[beyond] = False
    jp_gap = float(gap[within].max()) / unit if within.any() else 0.0
    repeats = bool(torch.equal(tk, tk2) and torch.equal(jk, jk2))
    return {"total_kernel": float(tk), "total_twin": float(tt),
            "total_gap": total_gap, "jp_gap": jp_gap,
            "ties": int(beyond.size) - unexplained,
            "unexplained": unexplained, "sources": int(gap.size),
            "empty_kernel": int((jk == 0).sum()),
            "empty_twin": int((jt == 0).sum()), "repeats": repeats,
            "ok": (unexplained == 0 and total_gap <= TOTAL_RTOL
                   and repeats)}


def time_cost(p, launches: int = 50) -> dict:
    """Milliseconds a call of K3 on the card's clock (windows between CUDA
    events, queued behind a device-side sleep so the host's launch rate
    cannot show), of a whole cost evaluation as rigid_align makes it
    (reg.rigid.rigid_cost: the rotation, then K3) back to back on the
    host's pace, and of the plain version, beside the bound of the call's
    work."""
    rot, src, tgt, tdat, cos_ang, sigma, simval = p
    k = time_launches(lambda: kernel(p), windows=5, launches=launches,
                      warmup=10, hold_cycles=launches * HOLD_CYCLES_A_LAUNCH)
    z = torch.zeros(3, dtype=torch.float32, device=rot.device)
    host = time_launches(
        lambda: _reg_rigid.rigid_cost(z, rot, src, tgt, tdat, cos_ang, sigma,
                                      simval), windows=5, launches=launches,
        warmup=10)
    plain = time_launches(lambda: rigid.rigid_terms_twin(*p), windows=3,
                          launches=5, warmup=2)
    b = bound(p, neighbourhood_pairs(p))
    return {"kernel_ms": k["ms"], "kernel_ms_spread": k["ms_spread"],
            "evaluation_ms": host["ms"], "plain_ms": plain["ms"],
            "plain_ms_spread": plain["ms_spread"], "share": b["bound_ms"]
            / k["ms"], "sources": int(rot.shape[0]),
            "targets": int(tgt.shape[0]), "channels": int(src.shape[0]),
            "clock_samples_mhz_w": k["clock_samples_mhz_w"], **b}


SHAPES = {"affine_ico5": lambda dev: problem(5, 2, 2, dev),
          "affine_ico5_d10_ssd": lambda dev: problem(5, 10, 1, dev)}
