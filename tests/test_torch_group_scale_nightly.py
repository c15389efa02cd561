"""S = 32 groupwise scale test of newmsm_tpu_torch over 4 ranks on the CPU:
the port's twin of tests/test_group_scale_nightly.py.

run_gmsm over 4 spawned gloo ranks (multihost.run_local_ranks), 8 subjects
a rank, on make_group(32, res=3, degrees=6, seed=1) with group_config
(iters=2) and an ico-3 template. It must finish with the mean pairwise CC
raised by more than 0.02, no patch overflow in any iteration, every
iteration on 4 ranks, and the same result on every rank.

Slow (minutes on the CPU), so skipped unless NEWMSM_NIGHTLY=1. Rank
workers are module-level functions and this module imports neither JAX nor
the JAX package at its top: spawned ranks import it by name.
"""
import json
import os

import numpy as np
import pytest

nightly = pytest.mark.skipif(
    os.environ.get("NEWMSM_NIGHTLY", "") != "1",
    reason="scale test; set NEWMSM_NIGHTLY=1 to run")

S = 32
WORLD = 4


def _scale_rank(case):
    import torch.distributed as dist
    from newmsm_tpu_torch.core.mesh import Mesh
    from newmsm_tpu_torch.pipelines.gmsm import run_gmsm
    meshes = [Mesh(coords=c, faces=case["faces"]) for c in case["coords"]]
    tmpl = Mesh(coords=case["tmpl"], faces=case["tmpl_faces"])
    res = run_gmsm(meshes, case["datasets"], tmpl, case["cfg"],
                   dedrift_warps=False, device="cpu", group=dist.group.WORLD,
                   metrics_path=case["metrics"])
    return dict(stats=res.stats, energies=res.energies, mean=res.mean_map)


@nightly
def test_groupwise_s32_over_four_ranks(tmp_path):
    from newmsm_tpu.core.mesh import Mesh as JMesh
    from newmsm_tpu_torch import convert
    from newmsm_tpu_torch.eval import metrics
    from newmsm_tpu_torch.parallel import multihost as mh
    from test_group import group_config, make_group
    from test_torch_group import torch_config

    meshes, datasets = make_group(S, res=3, degrees=6.0, seed=1)
    tmpl = convert.mesh(JMesh.from_icosphere(3))
    case = dict(coords=[convert.mesh(m).coords for m in meshes],
                faces=convert.mesh(meshes[0]).faces,
                datasets=[np.asarray(d) for d in datasets], tmpl=tmpl.coords,
                tmpl_faces=tmpl.faces, cfg=torch_config(group_config(iters=2)),
                metrics=str(tmp_path / "metrics.jsonl"))
    runs = mh.run_local_ranks(_scale_rank, WORLD, args=(case,),
                              timeout=3000, threads=1)

    before = metrics.mean_pairwise_cc([d[0] for d in case["datasets"]])
    after = runs[0]["stats"]["cc"]
    assert after > before + 0.02, (before, after)
    for r, run in enumerate(runs[1:], 1):
        assert run["stats"] == runs[0]["stats"], r
        assert run["energies"] == runs[0]["energies"], r
        np.testing.assert_array_equal(run["mean"], runs[0]["mean"])

    rows = [json.loads(line) for line in open(case["metrics"])]
    iters = [r for r in rows if r.get("event") == "iter"]
    assert iters, "metrics rows missing"
    assert sum(r["patch_overflow"] for r in iters) == 0
    assert all(r["devices"] == WORLD for r in iters)
