"""The plain reference (msmbench/reference/) at ico-3 on the CPU: against
the frozen generator's own geometry and truths, and against the program's
outputs of the same operations; and that it imports nothing of the
program or of JAX."""
from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from msmbench import synth
from msmbench.reference import geometry as G
from msmbench.reference import judge

HERE = pathlib.Path(__file__).resolve().parents[1]
F64 = torch.float64


def sphere(res=3):
    c, f = synth.icosphere(res)
    return torch.as_tensor(c, dtype=F64), torch.as_tensor(f.astype(np.int64))


def rotation(deg, axis=(1.0, 2.0, 3.0)):
    a = np.asarray(axis) / np.linalg.norm(axis)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    t = np.radians(deg)
    return np.eye(3) + np.sin(t) * k + (1 - np.cos(t)) * k @ k


def test_frozen_generator_is_the_programs_synth_cohort():
    from newmsm_tpu_torch.eval.synth import synth_cohort
    meshes, data, template = synth_cohort(3, 3, seed=0)
    coords, faces = synth.icosphere(3)
    assert np.array_equal(meshes[0].faces, faces)
    assert np.allclose(meshes[0].coords, coords, rtol=0, atol=1e-9)
    assert np.allclose(synth.template_data(3), template, atol=1e-12)
    for s in range(3):
        assert np.allclose(synth.subject_data(3, s), data[s], atol=1e-12)


def test_draw_subjects_is_set_by_large_seeds():
    a = synth.draw_subjects(2 ** 31 + 12345, 8)
    assert a == synth.draw_subjects(2 ** 31 + 12345, 8)
    assert len(set(a)) == 8
    assert a != synth.draw_subjects(2 ** 31 + 12346, 8)


def test_locate_finds_the_face_of_each_centroid():
    c, f = sphere()
    cen = c[f].mean(1)
    fid, w, outside = G.locate(cen, c, f)
    assert outside == 0
    assert torch.equal(fid, torch.arange(f.shape[0]))
    assert torch.allclose(w, torch.full_like(w, 1 / 3), atol=1e-12)


def test_resampling_onto_itself_is_the_identity():
    c, f = sphere()
    data = torch.as_tensor(synth.template_data(3), dtype=F64)
    out, outside = G.adaptive_resample(c, f, data, c, f)
    assert outside == 0
    assert torch.allclose(out, data, atol=1e-12)


def test_resampling_through_a_rotation_follows_the_analytic_field():
    """Data given on a rotated sphere, read back on the pristine one, is
    the analytic field at the rotated-back directions up to interpolation
    error at ico-4: far closer than the field rotated the other way."""
    c, f = sphere(4)
    r = rotation(5.0)
    moved = c.numpy() @ r.T
    unit = c.numpy() / synth.RAD
    data = synth.group_pattern(unit)                    # carried by `moved`
    out, _ = G.adaptive_resample(torch.as_tensor(moved), f,
                                 torch.as_tensor(data), c, f)
    truth = synth.group_pattern(unit @ r)[0]            # r^-1 applied
    wrong = synth.group_pattern(unit @ r.T)[0]
    err = np.abs(out.numpy()[0] - truth).mean()
    assert err < 0.03
    assert err < 0.1 * np.abs(out.numpy()[0] - wrong).mean()


def test_distortion_of_a_rotation_is_nought_and_of_a_stretch_is_known():
    c, f = sphere()
    r = torch.as_tensor(rotation(20.0))
    a, s = G.distortion(c, c @ r.T, f)
    assert torch.allclose(a, torch.zeros_like(a), atol=1e-10)
    assert torch.allclose(s, torch.zeros_like(s), atol=1e-10)
    a, s = G.distortion(c, 2.0 * c, f)                  # area x4
    assert torch.allclose(a, torch.full_like(a, 2.0), atol=1e-10)


def test_folded_faces_count_swapped_vertices():
    c, f = sphere()
    orient = G.face_orientation(c, f)
    assert G.folded_faces(c, f, orient) == 0
    bad = c.clone()
    v0, v1 = f[0, 0], f[0, 1]
    bad[v0], bad[v1] = c[v1], c[v0]
    assert G.folded_faces(bad, f, orient) > 0


def test_reference_resample_is_the_programs_to_float32():
    from newmsm_tpu_torch.core.mesh import Mesh
    from newmsm_tpu_torch.ops.resample import metric_resample
    coords, faces = synth.icosphere(3)
    unit = coords / synth.RAD
    warped = synth.true_warp(unit, 7, amplitude_deg=4.0) * synth.RAD
    data = synth.subject_data(3, 7)
    got, _ = metric_resample(Mesh(coords=warped, faces=faces, data=data),
                             Mesh(coords=coords, faces=faces), device="cpu")
    want, _ = G.adaptive_resample(
        torch.as_tensor(warped), torch.as_tensor(faces.astype(np.int64)),
        torch.as_tensor(data), torch.as_tensor(coords),
        torch.as_tensor(faces.astype(np.int64)))
    assert np.abs(got.data - want.numpy()).max() < 1e-4


def test_reference_distortion_is_the_programs():
    from newmsm_tpu_torch.core.mesh import Mesh
    from newmsm_tpu_torch.eval import metrics
    coords, faces = synth.icosphere(3)
    warped = synth.true_warp(coords / synth.RAD, 3) * synth.RAD
    a, s = metrics.distortion_maps(Mesh(coords=coords, faces=faces),
                                   Mesh(coords=warped, faces=faces))
    want = metrics.distortion_stats(a, s)
    ra, rs = G.distortion(torch.as_tensor(coords), torch.as_tensor(warped),
                          torch.as_tensor(faces.astype(np.int64)))
    assert np.allclose(ra.numpy(), a, atol=1e-12)
    assert np.allclose(rs.numpy(), s, atol=1e-10)
    got = G.distortion_stats(ra, rs)
    assert judge._stat_gap(got, want) < 1e-9


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -12, -3.0, 100.0 / 3])
    y = G.tf32_round(x)
    assert y[0] == x[0] and y[1] == 1.0 and y[2] == -3.0
    assert abs(float(y[3]) - 100 / 3) / (100 / 3) < 2 ** -11


REFERENCE_FILES = [HERE / "reference" / "geometry.py",
                   HERE / "reference" / "judge.py", HERE / "synth.py"]


def _imported_top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", REFERENCE_FILES, ids=lambda p: p.name)
def test_reference_sources_import_neither_the_program_nor_jax(path):
    bad = _imported_top_names(path) & {"jax", "jaxlib", "flax", "newmsm_tpu",
                                       "newmsm_tpu_torch"}
    assert not bad


def test_reference_modules_load_nothing_of_the_program_or_jax():
    code = ("import sys; import msmbench.reference.judge; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'newmsm_tpu', 'newmsm_tpu_torch')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_benchmark_file_reads_the_jax_packages_benchmark_files():
    for path in HERE.rglob("*.py"):
        text = path.read_text()
        if path.name.startswith("test_msmbench"):
            continue
        for word in ("bench_baselines", "BENCH_r", "MULTICHIP_",
                     "import jax", "from jax", "newmsm_tpu."):
            assert word not in text, (path, word)
        names = _imported_top_names(path)
        assert not names & {"jax", "jaxlib", "flax", "newmsm_tpu"}, path


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, 'msmbench/tests'); "
            "from msmbench_tiny import run_tiny; from msmbench import harness; "
            "result, _ = run_tiny('strain_warm'); "
            "bad = harness.forbidden_modules(); print(bad, result['correct']); "
            "sys.exit(1 if bad or not result['correct'] else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]


def test_forbidden_names_are_compared_whole(monkeypatch):
    from msmbench import harness
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "newmsm_tpu_torch_like", sys)
    assert "jaxtyping_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "newmsm_tpu.ops", sys)
    assert harness.forbidden_modules() == ["newmsm_tpu.ops"]


def test_a_run_without_the_program_exits_non_zero(tmp_path):
    import shutil
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "msmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "msmbench/run.py", "--workload", "strain_warm",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


def test_every_seed_orders_the_same_pool():
    """The seed orders the window's units; every unit keeps the pool's
    subjects in the pool's order."""
    warm_a, units_a = synth.arrange(7, 2 ** 31 + 1, 3, 1, 4)
    warm_b, units_b = synth.arrange(7, 2 ** 33 + 9, 3, 1, 4)
    assert warm_a == warm_b
    assert sorted(units_a) == sorted(units_b)
    assert units_a != units_b
    pool = synth.draw_subjects(7, 15)
    assert sorted(units_a) == sorted(pool[k:k + 3] for k in range(3, 15, 3))
    flat = [s for u in warm_a + units_a for s in u]
    assert len(set(flat)) == 15
