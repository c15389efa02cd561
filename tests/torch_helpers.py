"""Shared helpers for the tests that hold newmsm_tpu_torch against the JAX
package: seeded numpy inputs, conversion to both frameworks, and small
comparison utilities. JAX runs on the CPU (tests/conftest.py); torch is
held to a few threads because the suite runs in several workers."""
import numpy as np
import jax.numpy as jnp
import torch

torch.set_num_threads(2)


def unit_queries(n, seed=0, radius=100.0):
    """(n,3) float32 random directions at `radius`."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 3)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q * np.float32(radius)


def both(a, dtype=np.float32):
    """The same numpy array as (jax array, torch tensor)."""
    a = np.ascontiguousarray(np.asarray(a, dtype))
    return jnp.asarray(a), torch.from_numpy(a.copy())


def np_(x):
    """numpy view of a jax array or torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def warped_icosphere(res, seed=3, deg=4.0):
    """An ico-`res` mesh (radius 100) under a smooth random warp."""
    from newmsm_tpu.core.mesh import Mesh
    from newmsm_tpu.eval.synth import smooth_sphere_warp
    m = Mesh.from_icosphere(res)
    m.coords = smooth_sphere_warp(m.coords / 100.0, seed, deg) * 100.0
    return m


def bary_positions(coords, tv, w):
    """Weight-reconstructed positions sum_j w_j * coords[tv_j]."""
    return (np.asarray(coords)[np_(tv)] * np_(w)[..., None]).sum(1)



def assert_close_f32(port32, jax32, port64, rtol=2e-4, atol=1e-6):
    """Strain-like float32 values: a small strain is a difference of
    near-equal terms, so each package's float32 result is off the float64
    value by up to ~1e-4 relative (measured: 7.7e-5 for JAX on the strain
    fixtures). Both the port's float32 result and its float64 evaluation
    are held to rtol 2e-4 (atol 1e-6 for values near 0) against JAX."""
    j = np_(jax32)
    np.testing.assert_allclose(np_(port32), j, rtol=rtol, atol=atol)
    np.testing.assert_allclose(np_(port64), j, rtol=rtol, atol=atol)


def jax_fusion_starts(K, n_restarts=2):
    """The JAX package's fusion random starts (fusion.py:242-245), for
    injection into the port (torch cannot reproduce threefry)."""
    import jax

    def starts(alpha):
        key = jax.random.fold_in(jax.random.PRNGKey(7), alpha)
        return torch.from_numpy(np.array(jax.random.bernoulli(
            key, 0.5, (n_restarts, K)).astype(jnp.int32)))
    return starts


# Whole-driver variant configurations at ico-3 (the typical_config()
# structure of tests/test_parity.py with one family switched on each).
# --cprange=1.1: at the default 1.0 a CP's data-grid neighbours lie on the
# patch limit to 1 ulp at this scale, XLA's and torch's arcsin decide such
# ties differently, and the two runs then follow different descent paths
# (measured on the regoption-1 run: CC 0.822 against 0.873). Off the tie
# both packages give the same energies to 1e-5.
_VARIANT_BASE = """\
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
--VN
--cprange=1.1
"""
# the structure of tests/test_registration.py's small_config (one discrete
# level on a 10-degree rotated pair): the MCMC run with 1280 draws an
# iteration (10 sweeps of 128 proposals), and the triclique run (on the
# warped cohort subject above the triclique term alone leaves the sulc CC
# where it was, in both packages)
_ROTATED_BASE = """\
--opt=DISCRETE
--simval=2
--sigma_in=0
--sigma_ref=0
--lambda=0.1
--datagrid=3
--CPgrid=2
--SGgrid=4
--anatgrid=4
--regoption=3
--cprange=1.1
"""
VARIANT_CONFIGS = {
    "pair": _VARIANT_BASE.replace("--lambda=0,0.2,0.2", "--lambda=0,0.1,0.2")
    + "--dopt=HOCR\n--regoption=1\n",
    "patchwise": _VARIANT_BASE + "--dopt=HOCR\n--regoption=3\n--patchwise\n",
    "mcmc": _ROTATED_BASE + "--it=2\n--mciters=1280\n--dopt=MCMC\n",
    "triclique": _ROTATED_BASE + "--it=3\n--dopt=HOCR\n--triclique\n",
    "amsm": """\
--opt=DISCRETE,DISCRETE
--simval=2,2
--it=2,2
--sigma_in=2,1
--sigma_ref=2,1
--lambda=0.2,0.2
--datagrid=3,3
--CPgrid=1,2
--SGgrid=3,4
--anatgrid=2,3
--dopt=HOCR
--regoption=5
--triclique
""",
    # the HCP multimodal recipe's structure at ico-3: regoption 3 with the
    # multivariate triclique likelihood over every channel, two levels
    "multimodal": """\
--opt=DISCRETE,DISCRETE
--simval=2,2
--it=2,2
--sigma_in=2,1
--sigma_ref=2,1
--lambda=0.2,0.2
--datagrid=3,3
--CPgrid=1,2
--SGgrid=3,4
--dopt=HOCR
--regoption=3
--triclique
--VN
--cprange=1.1
""",
}


def run_variant_pair(tmp_path, which, cc_tol):
    """One whole-driver variant through the JAX package's CLI and the
    port's CLI (--device cpu) on the same GIFTI files: a synth_cohort(3)
    subject against its template, longitudinal_pair(3) with its anatomies
    for "amsm", the 10-degree rotated pair of fixtures.make_pair for
    "mcmc" and "triclique", or a multimodal_cohort(3, 1, n_channels=6)
    subject against its template for "multimodal". Asserts for both:
    outputs written, 0 folds, finite energies, sulc CC above the before-CC
    (multimodal: every channel's CC), `chosen_gated == 0` in every fold_gate
    event; and |CC_port - CC_jax| <= cc_tol (multimodal: of the mean CC over
    the channels). Returns the numbers."""
    import json
    from newmsm_tpu import cli as jcli
    from newmsm_tpu.core import io as mio
    from newmsm_tpu.core.mesh import Mesh
    from newmsm_tpu.eval.synth import (longitudinal_pair, multimodal_cohort,
                                       synth_cohort)
    from newmsm_tpu.ops.unfold import count_folds as jfolds
    from newmsm_tpu_torch import cli as tcli
    from newmsm_tpu_torch.core.mesh import Mesh as TMesh
    from newmsm_tpu_torch.ops.unfold import count_folds as tfolds

    d = tmp_path
    anat = which == "amsm"
    if anat:
        in_mesh, in_data, in_anat, ref_mesh, ref_data, ref_anat = \
            longitudinal_pair(3, seed=0)
        in_anat.save(str(d / "in.anat.surf.gii"))
        ref_anat.save(str(d / "ref.anat.surf.gii"))
    elif which == "multimodal":
        meshes, datasets, ref_data = multimodal_cohort(3, 1, n_channels=6,
                                                       seed=0)
        in_mesh, in_data = meshes[0], datasets[0]
        ref_mesh = Mesh.from_icosphere(3)
        ref_mesh.true_rescale(100.0)
    elif which in ("mcmc", "triclique"):
        from fixtures import make_pair
        in_mesh, in_data, ref_mesh, ref_data = make_pair(
            res=3, rot_degrees=10.0, seed=3)
    else:
        meshes, datasets, ref_data = synth_cohort(3, 1, seed=0, warp_deg=6.0)
        in_mesh, in_data = meshes[0], datasets[0]
        ref_mesh = Mesh.from_icosphere(3)
        ref_mesh.true_rescale(100.0)
    for name, m, data in (("in", in_mesh, in_data), ("ref", ref_mesh, ref_data)):
        m.save(str(d / f"{name}.surf.gii"))
        Mesh(coords=m.coords, faces=m.faces, data=data).save(
            str(d / f"{name}.func.gii"))
    (d / "config").write_text(VARIANT_CONFIGS[which])
    args = ["--inmesh", str(d / "in.surf.gii"), "--refmesh",
            str(d / "ref.surf.gii"), "--indata", str(d / "in.func.gii"),
            "--refdata", str(d / "ref.func.gii"), "--conf", str(d / "config")]
    if anat:
        args += ["--inanat", str(d / "in.anat.surf.gii"), "--refanat",
                 str(d / "ref.anat.surf.gii")]
    def ccs(data):
        """CC to the reference of every channel (only sulc unless
        multimodal)."""
        n = data.shape[0] if which == "multimodal" else 1
        return np.array([np.corrcoef(data[c], ref_data[c])[0, 1]
                         for c in range(n)])

    before = ccs(in_data)
    cc_before = float(before.mean())
    out = {"cc_before": cc_before, "profile": str(d / "profile")}
    runs = (("jax", jcli.main, (), lambda p: jfolds(Mesh.load(p))),
            ("torch", tcli.main, ("--device", "cpu", "--profile",
                                  out["profile"]),
             lambda p: tfolds(TMesh.load(p), device="cpu")))
    for name, main, extra, folds in runs:
        prefix = str(d / name) + "_"
        assert main([*args, "-o", prefix, "--metrics", prefix + "m.jsonl",
                     *extra]) == 0
        events = [json.loads(line) for line in open(prefix + "m.jsonl")]
        energies = [e["energy"] for e in events if e["event"] == "iter"]
        assert energies and np.isfinite(energies).all(), (name, energies)
        gates = [e for e in events if e["event"] == "fold_gate"]
        assert (len(gates) > 0) == (which == "pair"), name
        assert all(e["chosen_gated"] == 0 for e in gates), (name, gates)
        assert any(e["event"] == "level_distortion" for e in events), name
        assert folds(prefix + "sphere.reg.surf.gii") == 0, name
        data = mio.load_data(prefix + "transformed_and_reprojected.func.gii",
                             ref_mesh)
        assert data.shape == ref_data.shape and np.isfinite(data).all()
        after = ccs(data)
        out[name] = float(after.mean())
        out[name + "_energies"] = energies
        assert (after > before).all(), (name, before, after)
        if anat:
            assert Mesh.load(prefix + "anat.reg.surf.gii").coords.shape == \
                in_mesh.coords.shape, name
            strains = mio.load_data(prefix + "STRAINS.func.gii", in_mesh)
            assert strains.shape == (4, in_mesh.nvertices), name
            assert np.isfinite(strains).all(), name
    assert abs(out["torch"] - out["jax"]) <= cc_tol, out
    return out
