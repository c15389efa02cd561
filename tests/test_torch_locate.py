"""newmsm_tpu_torch: spherical math, the pristine locate (the plain twin of
the CUDA kernel, ops/locate.py) and the nearest-triangle search, held
against the JAX package on the same seeded inputs; plus the guards of the
port (no JAX import, CPU dispatch of the kernel wrapper, chip_smoke.py
refusing to run without a card)."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from newmsm_tpu.core import spherical as jsph
from newmsm_tpu.core.icosphere import icosphere
from newmsm_tpu.core.mesh import Mesh
from newmsm_tpu.ops import nearest as jnst
from newmsm_tpu.ops import pallas_locate as PL

from newmsm_tpu_torch import trace
from newmsm_tpu_torch.core import spherical as tsph
from newmsm_tpu_torch.ops import locate as tloc
from newmsm_tpu_torch.ops import nearest as tnst

from torch_helpers import bary_positions, both, np_, unit_queries, warped_icosphere

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------- spherical

def test_spherical_functions_match_jax():
    # unit-vector outputs agree to 1e-6 (float32 rounding of the same
    # formulas); coordinate-scale outputs (RAD=100) to 1e-4
    rng = np.random.default_rng(0)
    a, b, c, d = (rng.normal(size=(64, 3)).astype(np.float32)
                  for _ in range(4))
    aj, at = both(a)
    bj, bt = both(b)
    cj, ct = both(c)
    dj, dt = both(d)
    cases = [
        (jsph.normalize(aj), tsph.normalize(at), 1e-6),
        (jsph.rodrigues(aj, bj), tsph.rodrigues(at, bt), 1e-6),
        (jsph.rodrigues(aj, aj), tsph.rodrigues(at, at), 1e-6),
        (jsph.rodrigues(aj, -aj), tsph.rodrigues(at, -at), 1e-6),
        (jsph.tri_normal(aj, bj, cj), tsph.tri_normal(at, bt, ct), 1e-6),
        (jsph.project_to_plane(dj, aj, bj, cj),
         tsph.project_to_plane(dt, at, bt, ct), 1e-4),
        (jsph.barycentric_weights(aj, bj, cj, dj),
         tsph.barycentric_weights(at, bt, ct, dt), 1e-5),
        (jsph.point_in_triangle_relative(dj, aj, bj, cj),
         tsph.point_in_triangle_relative(dt, at, bt, ct), 0),
        (jsph.dist_to_triangle_boundary(dj, aj, bj, cj),
         tsph.dist_to_triangle_boundary(dt, at, bt, ct), 1e-5),
    ]
    for e in range(2):
        cases.append((jsph.tangent_basis_from_normal(aj)[e],
                      tsph.tangent_basis_from_normal(at)[e], 1e-6))
        cases.append((jsph.vertex_tangent_basis(jsph.normalize(aj))[e],
                      tsph.vertex_tangent_basis(tsph.normalize(at))[e], 1e-6))
    ang = [np.float32(x) for x in (0.1, -0.2, 0.3)]
    cases.append((jsph.apply_euler(aj, *ang),
                  tsph.apply_euler(at, *(torch.tensor(x) for x in ang)), 1e-6))
    for i, (j, t, atol) in enumerate(cases):
        np.testing.assert_allclose(np_(t), np_(j), atol=atol, rtol=0,
                                   err_msg=f"case {i}")


# ------------------------------------------------------------ locate twin

def _tie_equivalent(res, fid_a, w_a, fid_b, w_b, atol=2e-4):
    """Face-id mismatches must be boundary ties: the weight-reconstructed
    positions agree (2e-4 on the unit sphere, the JAX package's on-device
    probe tolerance, pallas_locate.py:149-158)."""
    ico = icosphere(res)
    pa = bary_positions(ico.coords, ico.faces[np_(fid_a)], np.stack(
        [np_(w) for w in w_a], 1))
    pb = bary_positions(ico.coords, ico.faces[np_(fid_b)], np.stack(
        [np_(w) for w in w_b], 1))
    np.testing.assert_allclose(pa, pb, atol=atol, rtol=0)


@pytest.mark.parametrize("res", [0, 2, 5])
def test_locate_twin_matches_pallas_kernel(res):
    """The twin against the Pallas kernel (interpret mode): face ids equal
    apart from documented boundary ties (at most 1e-3 of random queries,
    each value-equivalent); weights of equal faces within 1e-5."""
    q = unit_queries(4000, seed=res)
    jx, tx = both(q[:, 0])
    jy, ty = both(q[:, 1])
    jz, tz = both(q[:, 2])
    fid_j, *w_j = PL.locate_bary_pallas(jx, jy, jz, res, interpret=True)
    fid_t, *w_t = tloc.locate_bary(tx, ty, tz, res)
    assert fid_t.dtype == torch.int32
    same = np_(fid_j) == np_(fid_t)
    assert (~same).sum() <= 1e-3 * len(q)
    for a, b in zip(w_j, w_t):
        np.testing.assert_allclose(np_(b)[same], np_(a)[same], atol=1e-5,
                                   rtol=0)
    _tie_equivalent(res, fid_j, w_j, fid_t, w_t)


def test_locate_twin_matches_xla_scan_path():
    """_locate_pristine_soa + _bary_weights_soa of both packages on unit
    queries (the JAX package's XLA path)."""
    res = 4
    q = unit_queries(3000, seed=11, radius=1.0)
    comps = [both(q[:, i]) for i in range(3)]
    fid_j, *cj = jnst._locate_pristine_soa(*(c[0] for c in comps), res)
    fid_t, *ct = tnst._locate_pristine_soa(*(c[1] for c in comps), res)
    wj = jnst._bary_weights_soa(tuple(c[0] for c in comps), *cj)
    wt = tnst._bary_weights_soa(tuple(c[1] for c in comps), *ct)
    same = np_(fid_j) == np_(fid_t)
    assert (~same).sum() <= 1e-3 * len(q)
    for vj, vt in zip(cj, ct):
        for a, b in zip(vj, vt):
            np.testing.assert_allclose(np_(b)[same], np_(a)[same], atol=1e-6)
    _tie_equivalent(res, fid_j, wj, fid_t, wt)


def test_locate_partition_of_unity_at_vertices():
    # vertex queries sit on face boundaries: the face must be incident and
    # carry the whole mass (weights sum to 1 within 1e-5, mass within 1e-4)
    res = 3
    ico = icosphere(res)
    q = torch.from_numpy(ico.coords.astype(np.float32) * 100.0)
    fid, *w = tloc.locate_bary(q[:, 0].contiguous(), q[:, 1].contiguous(),
                               q[:, 2].contiguous(), res)
    W = np.stack([np_(x) for x in w], 1)
    np.testing.assert_allclose(W.sum(1), 1.0, atol=1e-5)
    hit = ico.faces[np_(fid)] == np.arange(ico.nvertices)[:, None]
    assert hit.any(axis=1).all()
    np.testing.assert_allclose(W[hit], 1.0, atol=1e-4)


def test_locate_wrapper_dispatches_to_twin_on_cpu(monkeypatch):
    """On CPU tensors the wrapper runs the plain version, never the kernel
    (the library is not even loaded) and counts no launch."""
    monkeypatch.setattr(tloc.SEAM, "tally", dict(kernel=0, twin=0,
                                                 largest=0))
    monkeypatch.setattr(tloc.SEAM, "library", lambda: pytest.fail(
        "kernel library requested for CPU tensors"))
    q = torch.from_numpy(unit_queries(100))
    out = tloc.locate_bary(q[:, 0].contiguous(), q[:, 1].contiguous(),
                           q[:, 2].contiguous(), 2)
    ref = tloc.locate_bary_reference(q[:, 0], q[:, 1], q[:, 2], 2)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert tloc.SEAM.tally["kernel"] == 0


def test_traced_cpu_locate_counts_one_twin_a_call(monkeypatch):
    """Under tracing, each locate_bary call on CPU tensors is one
    `locate.twin` count of the enclosing span and one twin call of the
    kernel's tally, never a `locate.kernel`, and never asks for the
    library; a meta tensor raises and counts nothing."""
    monkeypatch.setattr(tloc.SEAM, "tally", dict(kernel=0, twin=0,
                                                 largest=0))
    monkeypatch.setattr(tloc.SEAM, "library", lambda: pytest.fail(
        "kernel library requested for CPU tensors"))
    q = torch.from_numpy(unit_queries(64))
    px, py, pz = (q[:, i].contiguous() for i in range(3))
    with trace.run(None, "cpu", on=True):
        with trace.span("unary") as span:
            for res in (1, 2, 3):
                tloc.locate_bary(px, py, pz, res)
            with pytest.raises(ValueError, match="unsupported device"):
                tloc.locate_bary(px.to("meta"), py.to("meta"),
                                 pz.to("meta"), 2)
    assert span.counters["locate.twin"] == 3
    assert "locate.kernel" not in span.counters
    assert tloc.SEAM.tally == dict(kernel=0, twin=3, largest=0)


def test_kernel_source_and_build_command():
    from newmsm_tpu_torch.ops import _build
    src = _build.CSRC_DIR / tloc.SOURCE
    assert src.exists()
    text = src.read_text()
    assert 'extern "C" int locate_bary_launch' in text
    assert "pallas_locate.py::_locate_kernel" in text
    cmd = _build.nvcc_command(src, pathlib.Path("x.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    lib = _build.library_path(tloc.SOURCE)
    assert lib.parent == ROOT / "build" / "newmsm_tpu_torch"
    assert lib.parent.parent.name in (ROOT / ".gitignore").read_text()


def _locate_carried(u, res):
    """The CUDA kernel's descent, written on the plain ops: per level three
    NEW mid planes; the chosen child's own edge planes are carried from
    planes the level already holds, and the orientation sign is taken once
    from the base face. Returns (fid, max |carried - recomputed| over the
    levels and the three edge planes)."""
    bc, bn = tnst._base_tables_on(u[0].device)
    smin = torch.stack([u[0][:, None] * bn[:, e, 0] + u[1][:, None] * bn[:, e, 1]
                        + u[2][:, None] * bn[:, e, 2] for e in range(3)]).min(0)
    fid = torch.argmax(smin.values, dim=1)
    c = bc[fid]
    va, vb, vc = ((c[:, i, 0], c[:, i, 1], c[:, i, 2]) for i in range(3))
    sab, sbc, sca = (tnst._dot3(u, tuple(bn[fid][:, e, i] for i in range(3)))
                     for e in range(3))
    og = torch.where(tnst._dot3(tnst._cross3(va, vb), vc) >= 0, 1.0, -1.0)
    uo = tuple(a * og for a in u)

    def mid(a, b):
        x, y, z = a[0] + b[0], a[1] + b[1], a[2] + b[2]
        inv = torch.rsqrt(x * x + y * y + z * z)
        return x * inv, y * inv, z * inv

    def pdist(n):
        return tnst._dot3(uo, n) * torch.rsqrt(tnst._dot3(n, n))

    def sdist(n, r):          # the plain version's recomputed plane
        du = tnst._dot3(u, n) * torch.rsqrt(tnst._dot3(n, n))
        return torch.where(tnst._dot3(r, n) >= 0, du, -du)

    worst = 0.0
    for _ in range(res):
        m01, m12, m02 = mid(va, vb), mid(vb, vc), mid(va, vc)
        s1 = pdist(tnst._cross3(m01, m12))
        s2 = pdist(tnst._cross3(m12, m02))
        s3 = pdist(tnst._cross3(m02, m01))
        best = torch.minimum(s1, torch.minimum(s2, s3))
        k = torch.zeros_like(fid)
        for kk, s in ((1, torch.minimum(sca, torch.minimum(sab, -s3))),
                      (3, torch.minimum(sab, torch.minimum(sbc, -s1))),
                      (2, torch.minimum(sbc, torch.minimum(sca, -s2)))):
            upd = s > best
            best = torch.where(upd, s, best)
            k = torch.where(upd, torch.full_like(k, kk), k)
        fid = 4 * fid + k
        ka, kb, kc = k == 1, k == 3, k == 2

        def sel(a, b, c_, ctr):
            return torch.where(ka, a, torch.where(kb, b, torch.where(
                kc, c_, ctr)))

        na = tuple(sel(m02[i], m01[i], m12[i], m01[i]) for i in range(3))
        nb = tuple(sel(va[i], vb[i], vc[i], m12[i]) for i in range(3))
        nc = tuple(sel(m01[i], m12[i], m02[i], m02[i]) for i in range(3))
        sab, sbc, sca = (sel(sca, sab, sbc, s1), sel(sab, sbc, sca, s2),
                         sel(-s3, -s1, -s2, s3))
        va, vb, vc = na, nb, nc
        for carried, n, r in ((sab, tnst._cross3(va, vb), vc),
                              (sbc, tnst._cross3(vb, vc), va),
                              (sca, tnst._cross3(vc, va), vb)):
            worst = max(worst, float((carried - sdist(n, r)).abs().max()))
    return fid, worst


@pytest.mark.parametrize("res", range(7))
def test_carried_planes_equal_recomputed_planes(res):
    """The identity the CUDA kernel's descent relies on: the edge planes of
    the chosen child, carried down from the parent level's planes (sign
    flipped for the cut-off mid plane) with one orientation sign per query,
    equal the planes recomputed from the child's corners within 1e-6 up to
    res 4 and within 4e-8 * 2^res above (a recomputed normal is the cross
    product of corners one edge apart, and the edge halves per level, so
    its float32 rounding doubles: measured 1.7e-7, 3.9e-7, 9.1e-7, 1.8e-6
    at res 3..6), and the face ids they select differ from the plain
    version's on at most 1e-4 of 2^16 queries (exact boundary ties only)."""
    q = unit_queries(1 << 16, seed=40 + res, radius=1.0)
    u = tuple(torch.from_numpy(np.ascontiguousarray(q[:, i]))
              for i in range(3))
    fid_c, worst = _locate_carried(u, res)
    fid_p = tloc.locate_bary_reference(*u, res)[0]
    assert worst <= max(1e-6, 4e-8 * 2 ** res)
    assert int((fid_c != fid_p.long()).sum()) <= 1e-4 * len(q)


# ------------------------------------------------------------ search tier

def _tables(mesh):
    return (jnst.build_tables(mesh.coords, mesh.faces, mesh.adjacency[2]),
            tnst.build_tables(mesh.coords, mesh.faces, mesh.adjacency[2],
                              device="cpu"))


@pytest.mark.parametrize("res,warped", [(3, False), (4, False), (3, True),
                                        (4, True)])
def test_search_and_barycentric_coords(res, warped):
    """Pristine and warped ico-3/ico-4 targets: the same SearchTables, and
    the same interpolated positions (atol 1e-4 at RAD=100; measured 2e-5)
    and values (atol 1e-4 on unit-variance data; measured 5e-6). Faces may
    differ only at boundary ties, where both faces give those values."""
    mesh = warped_icosphere(res) if warped else Mesh.from_icosphere(res)
    jt, tt = _tables(mesh)
    assert tt.pristine_res == jt.pristine_res
    assert len(tt.descent) == len(jt.descent)
    assert (tt.pristine_res >= 0) == (not warped)
    np.testing.assert_array_equal(np_(tt.ring_faces), np_(jt.ring_faces))

    q = unit_queries(3000, seed=res + 10 * warped)
    qj, qt = both(q)
    tv_j, w_j = jnst.barycentric_coords(qj, jt)
    tv_t, w_t = tnst.barycentric_coords(qt, tt)
    diff = (np_(tv_j) != np_(tv_t)).any(1)
    assert diff.sum() <= 2e-3 * len(q)
    pos_j = bary_positions(mesh.coords, tv_j, w_j)
    pos_t = bary_positions(mesh.coords, tv_t, w_t)
    np.testing.assert_allclose(pos_t, pos_j, atol=1e-4)
    data = np.random.default_rng(res).normal(size=mesh.nvertices)
    np.testing.assert_allclose((data[np_(tv_t)] * np_(w_t)).sum(1),
                               (data[np_(tv_j)] * np_(w_j)).sum(1), atol=1e-4)
    same = ~diff
    np.testing.assert_allclose(np_(w_t)[same], np_(w_j)[same], atol=1e-4)
    np.testing.assert_array_equal(
        np_(tnst.closest_vertex(qt, tt))[same],
        np_(jnst.closest_vertex(qj, jt))[same])
    np.testing.assert_array_equal(np_(tnst.nearest_triangle(qt, tt))[same],
                                  np_(jnst.nearest_triangle(qj, jt))[same])


def test_resample_pristine_soa_matches_jax():
    target = Mesh.from_icosphere(3)
    jt, tt = _tables(target)
    data = np.random.default_rng(1).normal(size=(2, target.nvertices))
    dj, dt = both(data)
    q = unit_queries(500, seed=7)
    comps = [both(q[:, i]) for i in range(3)]
    out_j = jnst.resample_pristine_soa(*(c[0] for c in comps), jt, dj)
    out_t = tnst.resample_pristine_soa(*(c[1] for c in comps), tt, dt)
    np.testing.assert_allclose(np_(out_t), np_(out_j), atol=1e-4)


# ------------------------------------------------------------------ guards

def test_port_imports_no_jax():
    """Every module of the port imports without loading JAX."""
    mods = sorted(
        "newmsm_tpu_torch." + str(p.relative_to(ROOT / "newmsm_tpu_torch")
                                  .with_suffix("")).replace(os.sep, ".")
        for p in (ROOT / "newmsm_tpu_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.'))\n"
            "assert not bad, bad\nprint(len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert len(mods) >= 15


def test_chip_smoke_refuses_without_gpu(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    # alone in a directory, without the rest of the repo, it fails too
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
