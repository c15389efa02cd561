"""The whole pairwise strain-registration slice: typical_config() (the
config_standard_MSM_strain structure at ico-3, tests/test_parity.py) on one
subject of the test_parity cohort, through the JAX package's CLI and the
port's CLI (--device cpu) on the same GIFTI files."""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from newmsm_tpu import cli as jcli
from newmsm_tpu.core import io as mio
from newmsm_tpu.core.mesh import Mesh
from newmsm_tpu.eval.synth import synth_cohort
from newmsm_tpu.ops import unfold as junf
from newmsm_tpu.reg import driver as jdriver
from newmsm_tpu.reg import featurespace as jfeat
from newmsm_tpu.reg import model as jmodel
from newmsm_tpu.reg.config import parse_config

from newmsm_tpu_torch import cli as tcli
from newmsm_tpu_torch.ops import unfold as tunf
from newmsm_tpu_torch.reg import driver as tdriver
from newmsm_tpu_torch.reg import costs as tcosts
from newmsm_tpu_torch.reg import featurespace as tfeat
from newmsm_tpu_torch.reg.optimise import fusion as tfusion

from test_parity import typical_config

TYPICAL_CONFIG_TEXT = """\
--opt=AFFINE,DISCRETE,DISCRETE
--simval=2,2,2
--it=10,3,3
--sigma_in=2,2,1
--sigma_ref=2,2,1
--lambda=0,0.2,0.2
--datagrid=3,3,3
--CPgrid=0,1,2
--SGgrid=0,3,4
--anatgrid=3,3,3
--mciters=0,0,0
--dopt=HOCR
--regoption=3
--VN
"""


@pytest.fixture(scope="module")
def slice_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("slice")
    meshes, datasets, template_data = synth_cohort(3, 4, seed=0, warp_deg=6.0)
    template = Mesh.from_icosphere(3)
    template.true_rescale(100.0)
    args = []
    for name, mesh, data in (("in", meshes[0], datasets[0]),
                             ("ref", template, template_data)):
        mesh.save(str(d / f"{name}.surf.gii"))
        Mesh(coords=mesh.coords, faces=mesh.faces, data=data).save(
            str(d / f"{name}.func.gii"))
    conf = d / "config"
    conf.write_text(TYPICAL_CONFIG_TEXT)
    assert parse_config(str(conf)) == typical_config()
    args = ["--inmesh", str(d / "in.surf.gii"), "--refmesh",
            str(d / "ref.surf.gii"), "--indata", str(d / "in.func.gii"),
            "--refdata", str(d / "ref.func.gii"), "--conf", str(conf)]
    return d, args, template


def _run(main, args, out, extra=()):
    rc = main([*args, "-o", str(out) + "_", "--metrics", str(out) + ".jsonl",
               *extra])
    assert rc == 0
    events = [json.loads(line) for line in open(str(out) + ".jsonl")]
    energies = [e["energy"] for e in events if e["event"] == "iter"]
    return str(out) + "_", energies


def _cc(a, b):
    return float(np.corrcoef(a, b)[0, 1])


def test_slice_matches_jax_through_the_cli(slice_inputs, monkeypatch):
    d, args, template = slice_inputs
    projected = {}
    real_project = jdriver.MeshRegistration._project_cpgrid

    def recording_project(self):
        out = real_project(self)
        projected[self.level] = (out.copy(), self.model and
                                 self.model.cp_grid.copy())
        return out

    features = []
    real_features = jfeat.initialise

    def recording_features(*a, **kw):
        features.append(real_features(*a, **kw))
        return features[-1]

    patches = []
    real_setup = jmodel.PairwiseModel.setup_iteration

    def recording_setup(self, cfw):
        s = real_setup(self, cfw)
        patches.append((np.asarray(s["patch_idx"]), np.asarray(s["patch_mask"])))
        return s

    monkeypatch.setattr(jdriver.MeshRegistration, "_project_cpgrid",
                        recording_project)
    monkeypatch.setattr(jfeat, "initialise", recording_features)
    monkeypatch.setattr(jmodel.PairwiseModel, "setup_iteration",
                        recording_setup)
    out_j, e_j = _run(jcli.main, args, d / "jax")
    out_t, e_t = _run(tcli.main, args, d / "torch", ("--device", "cpu"))

    in_data = mio.load_data(args[5], template)
    ref_data = mio.load_data(args[7], template)
    cc_before = _cc(in_data[0], ref_data[0])
    cc = {}
    for name, out, count in (("jax", out_j, junf.count_folds),
                             ("torch", out_t, tunf.count_folds)):
        warped = Mesh.load(out + "sphere.reg.surf.gii")
        assert count(warped) == 0, name
        data = mio.load_data(out + "transformed_and_reprojected.func.gii",
                             template)
        assert data.shape == ref_data.shape and np.isfinite(data).all()
        cc[name] = _cc(data[0], ref_data[0])
    # measured: before 0.821, JAX 0.837, port 0.844
    assert cc["jax"] > cc_before and cc["torch"] > cc_before, (cc_before, cc)
    assert abs(cc["torch"] - cc["jax"]) <= 0.01, cc
    assert len(e_t) == len(e_j) and np.isfinite(e_t).all()

    # first discrete iteration from the same state: the JAX package's level
    # features, its level-2 projected sphere and CP grid, its first patches
    # and its fusion starts injected into the port -> the same energy. Run
    # independently, the energies differ by up to ~1e-2 relative: float32
    # rounding (~3e-5 at RAD=100 in the rigid result) moves near-tie ICM
    # decisions, and patch membership is a tie at this scale (CP-1 vertices
    # are data-grid vertices whose neighbours lie on the patch limit to
    # 1 ulp, so XLA's and torch's arcsin decide it differently).
    replay = iter(features)
    real_patches = tcosts.build_patches

    def jax_patches(*a, **kw):
        if patches:
            idx, mask = patches.pop(0)
            patches.clear()
            return (torch.from_numpy(idx.astype(np.int64)),
                    torch.from_numpy(mask.copy()),
                    torch.zeros(len(idx), dtype=bool))
        return real_patches(*a, **kw)
    real_t_project = tdriver.MeshRegistration._project_cpgrid

    def jax_projection(self):
        if self.level != 2:
            return real_t_project(self)
        sph, cp = projected[2]
        self.model.cp_grid = cp.copy()
        return sph.copy()

    real_fusion = tfusion.fusion_optimize

    def with_jax_starts(labeling, *a, **kw):
        K = labeling.shape[0]

        def starts(alpha):
            key = jax.random.fold_in(jax.random.PRNGKey(7), alpha)
            return torch.from_numpy(np.array(jax.random.bernoulli(
                key, 0.5, (2, K)).astype(jnp.int32)))
        return real_fusion(labeling, *a, random_starts=starts, **kw)

    monkeypatch.setattr(tdriver.MeshRegistration, "_project_cpgrid",
                        jax_projection)
    monkeypatch.setattr(tfusion, "fusion_optimize", with_jax_starts)
    monkeypatch.setattr(tfeat, "initialise", lambda *a, **kw: next(replay))
    monkeypatch.setattr(tcosts, "build_patches", jax_patches)
    _, e_s = _run(tcli.main, args, d / "torch_same", ("--device", "cpu"))
    np.testing.assert_allclose(e_s[0], e_j[0], rtol=1e-4)


def test_cli_device_flag():
    """--device cuda without a card raises; --groupwise is not ported."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(["--inmesh", "x.surf.gii", "--device", "cuda"])
    with pytest.raises(NotImplementedError, match="groupwise"):
        tcli.main(["--groupwise"])
