"""newmsm_tpu_torch stands alone: with JAX and the JAX package made
unimportable, every module of the port and chip_smoke.py import, two ranks
run, and the port's CLI registers a small synthetic subject, and a group of
three, on the CPU; and no source line of the port imports the JAX
package."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "newmsm_tpu_torch"

# refuses `jax`, `jax.*`, `jaxlib*`, `newmsm_tpu` and `newmsm_tpu.*`; the
# port's own name, `newmsm_tpu_torch`, passes
BLOCKER = '''
import importlib.abc, sys

class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "newmsm_tpu"):
            raise ImportError(f"refused in this test: {name}")
        return None

sys.meta_path.insert(0, _Refuse())
for _m in list(sys.modules):
    assert _m.split(".")[0] not in ("jax", "jaxlib", "newmsm_tpu"), _m
'''

CONFIG = """\
--opt=AFFINE,DISCRETE,DISCRETE
--simval=2,2,2
--it=3,1,2
--sigma_in=2,2,1
--sigma_ref=2,2,1
--lambda=0,0.2,0.2
--datagrid=3,3,3
--CPgrid=0,1,2
--SGgrid=0,3,4
--dopt=HOCR
--regoption=3
--VN
"""


def _port_modules():
    return sorted(
        "newmsm_tpu_torch." + str(p.relative_to(PORT).with_suffix(""))
        .replace(os.sep, ".") for p in PORT.rglob("*.py")
        if p.name != "__init__.py")


def _run(code, cwd=ROOT, timeout=600):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-c", BLOCKER + code], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout,
                          env=env)


def test_blocker_refuses_the_jax_package_only():
    proc = _run("import newmsm_tpu_torch\n"
                "for name in ('jax', 'jax.numpy', 'newmsm_tpu',\n"
                "             'newmsm_tpu.core.icosphere'):\n"
                "    try:\n"
                "        __import__(name)\n"
                "    except ImportError:\n"
                "        continue\n"
                "    raise SystemExit(f'{name} imported')\n")
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_every_module_and_chip_smoke_import_without_the_jax_package():
    mods = _port_modules()
    assert len(mods) >= 32
    for new in ("parallel.group_fusion", "reg.group", "pipelines.gmsm",
                "pipelines.cohort", "eval.reports", "tools.resample_tools",
                "core.sparse", "parallel.multihost",
                "parallel.pairwise_sharding",
                "tools.parity", "tools.flagship"):
        assert "newmsm_tpu_torch." + new in mods, new
    proc = _run("import importlib\n"
                f"for m in {mods!r}: importlib.import_module(m)\n"
                "import chip_smoke\n"
                "assert chip_smoke.STRAIN_CONFIG and chip_smoke.MAIN_RES == 6\n"
                "assert chip_smoke.GROUP_CONFIG and chip_smoke.GROUP_SUBJECTS == 6\n"
                "assert 'matplotlib' not in sys.modules\n"
                "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
                "('jax', 'jaxlib', 'newmsm_tpu'))\n"
                "assert not bad, bad\n")
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_flagship_configs_are_the_smoke_recipes():
    """tools.flagship runs chip_smoke.py's aMSM and multimodal config texts
    at 10 iterations a level (the smoke cuts them to 2)."""
    proc = _run("import chip_smoke\n"
                "from newmsm_tpu_torch.tools import flagship as fl\n"
                "it = chip_smoke.AMSM_ITERS\n"
                "assert fl.AMSM_CONFIG.format(iters=it) == "
                "chip_smoke.AMSM_CONFIG\n"
                "assert fl.MULTIMODAL_CONFIG.format(iters=it) == "
                "chip_smoke.MULTIMODAL_CONFIG\n"
                "assert fl.FULL_ITERS == '10,10,10'\n")
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_ranks_run_without_the_jax_package():
    """Two gloo ranks spawned by multihost.run_local_ranks from a process
    that cannot import JAX, each with the process group up: each gets its
    own subject slice."""
    proc = _run("from newmsm_tpu_torch.parallel import multihost as mh\n"
                "got = mh.run_local_ranks(mh.process_subject_slice, 2,\n"
                "                         args=(4,), timeout=120, threads=1)\n"
                "assert got == [slice(0, 2), slice(2, 4)], got\n"
                "print('ranks ran')\n")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ranks ran" in proc.stdout


def test_cli_registers_a_subject_without_the_jax_package(tmp_path):
    """ico-3 synth_cohort subject, iterations cut, --device cpu: a written,
    fold-free sphere and finite transformed data."""
    code = f'''
import numpy as np
d = {str(tmp_path)!r}
from newmsm_tpu_torch import cli
from newmsm_tpu_torch.core import io as mio
from newmsm_tpu_torch.core.mesh import Mesh
from newmsm_tpu_torch.eval.synth import synth_cohort
from newmsm_tpu_torch.ops.unfold import count_folds
meshes, datasets, template_data = synth_cohort(3, 1, seed=0, warp_deg=6.0)
template = Mesh.from_icosphere(3)
for name, mesh, data in (("in", meshes[0], datasets[0]),
                         ("ref", template, template_data)):
    mesh.save(f"{{d}}/{{name}}.surf.gii")
    Mesh(coords=mesh.coords, faces=mesh.faces, data=data).save(
        f"{{d}}/{{name}}.func.gii")
open(f"{{d}}/conf", "w").write({CONFIG!r})
rc = cli.main(["--inmesh", f"{{d}}/in.surf.gii", "--refmesh",
               f"{{d}}/ref.surf.gii", "--indata", f"{{d}}/in.func.gii",
               "--refdata", f"{{d}}/ref.func.gii", "--conf", f"{{d}}/conf",
               "-o", f"{{d}}/out_", "--device", "cpu"])
assert rc == 0
warped = Mesh.load(f"{{d}}/out_sphere.reg.surf.gii")
assert warped.coords.shape == (642, 3)
assert np.allclose(np.linalg.norm(warped.coords, axis=1), 100.0, atol=1e-3)
assert count_folds(warped, device="cpu") == 0
out = mio.load_data(f"{{d}}/out_transformed_and_reprojected.func.gii",
                    template)
assert out.shape == (2, 642) and np.isfinite(out).all()
print("registered")
'''
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "registered" in proc.stdout
    assert (tmp_path / "out_sphere.reg.surf.gii").exists()


GROUP_CONFIG = """\
--opt=DISCRETE
--simval=2
--it=2
--sigma_in=0
--sigma_ref=0
--lambda=0.1
--datagrid=3
--CPgrid=1
--SGgrid=3
--dopt=HOCR
--regoption=3
"""


def test_cli_registers_a_group_without_the_jax_package(tmp_path):
    """--groupwise --device cpu on three ico-3 synth_cohort subjects with
    list files: one fold-free sphere and one finite transformed map a
    subject, and the mean pairwise sulc CC raised."""
    code = f'''
import numpy as np
d = {str(tmp_path)!r}
from newmsm_tpu_torch import cli
from newmsm_tpu_torch.core import io as mio
from newmsm_tpu_torch.core.mesh import Mesh
from newmsm_tpu_torch.eval.metrics import mean_pairwise_cc
from newmsm_tpu_torch.eval.synth import synth_cohort
from newmsm_tpu_torch.ops.unfold import count_folds
meshes, datasets, _ = synth_cohort(3, 3, seed=0, warp_deg=6.0)
template = Mesh.from_icosphere(3)
template.save(f"{{d}}/template.surf.gii")
for s, (mesh, data) in enumerate(zip(meshes, datasets)):
    mesh.save(f"{{d}}/s{{s}}.surf.gii")
    Mesh(coords=mesh.coords, faces=mesh.faces, data=data).save(
        f"{{d}}/s{{s}}.func.gii")
open(f"{{d}}/meshes.txt", "w").write(
    "".join(f"{{d}}/s{{s}}.surf.gii\\n" for s in range(3)))
open(f"{{d}}/data.txt", "w").write(
    "".join(f"{{d}}/s{{s}}.func.gii\\n" for s in range(3)))
open(f"{{d}}/conf", "w").write({GROUP_CONFIG!r})
rc = cli.main(["--groupwise", "--meshes", f"{{d}}/meshes.txt", "--data",
               f"{{d}}/data.txt", "--template", f"{{d}}/template.surf.gii",
               "--conf", f"{{d}}/conf", "-o", f"{{d}}/out_", "--device", "cpu"])
assert rc == 0
maps = []
for s in range(3):
    warped = Mesh.load(f"{{d}}/out_sphere-{{s}}.reg.surf.gii")
    assert warped.coords.shape == (642, 3)
    assert count_folds(warped, device="cpu") == 0
    maps.append(mio.load_data(
        f"{{d}}/out_transformed_and_reprojected-{{s}}.func.gii", template))
    assert maps[-1].shape == (2, 642) and np.isfinite(maps[-1]).all()
assert mean_pairwise_cc([m[0] for m in maps]) > mean_pairwise_cc(
    [x[0] for x in datasets])
print("group registered")
'''
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "group registered" in proc.stdout


def _imports(path):
    """(module, line) of every import statement of a source file: the
    syntax tree, so docstrings and comments do not count."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", node.lineno


@pytest.mark.parametrize("banned", ["newmsm_tpu", "jax"])
def test_no_source_line_imports(banned):
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 40
    hits = [(str(f.relative_to(ROOT)), line, mod) for f in files
            for mod, line in _imports(f) if mod.split(".")[0] == banned]
    assert not hits, hits
