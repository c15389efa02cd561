"""The binary-ICM kernel's wrapper (newmsm_tpu_torch/ops/icm.py, K2) and
what feeds it, on the CPU: CPU tensors go to the plain version (the twin,
in the same module) and never load the library, tensors on any other
device raise; the wrapper refuses what the kernel does not take; the
flat colour tables the kernel reads are the concatenated colour groups;
a traced CPU run counts one `icm.twin` a fusion move or alpha step and no
`icm.kernel`, and the group driver's `ranks` event reports K2's launches
by rank; the kernel's build command, and one build of every csrc/ source
at the default flags; the floor problems of the card's timing; the
per-path launch check of chip_smoke.py. The kernel itself runs only on the
card (tests/test_torch_cuda.py).
"""
from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest
import torch

from newmsm_tpu_torch import convert, trace
from newmsm_tpu_torch.core.mesh import Mesh
from newmsm_tpu_torch.ops import _build, icm, icm_bench
from newmsm_tpu_torch.parallel import group_fusion as GF
from newmsm_tpu_torch.reg.config import RegConfig
from newmsm_tpu_torch.reg.optimise import fusion as FU

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORMS = ["t8", "p4", "group"]


def _problem(form, integer=False):
    if form == "group":
        return icm_bench.group_problem(3, 1, "cpu", seed=2, integer=integer)
    return icm_bench.pairwise_problem(2, form, "cpu", seed=2, integer=integer)


@pytest.mark.parametrize("form", FORMS)
def test_cpu_tensors_run_the_twin_and_never_load_the_library(form,
                                                            monkeypatch):
    """icm.icm_binary on CPU tensors: the plain descent and energy, bit
    for bit, one twin call and no launch counted, the library never asked
    for."""
    monkeypatch.setattr(icm.SEAM, "tally", dict(kernel=0, twin=0, largest=0))
    monkeypatch.setattr(icm.SEAM, "library", lambda: pytest.fail(
        "kernel library requested for CPU tensors"))
    p = _problem(form)
    x0 = p[0].clone()
    xs, es = icm.icm_binary(*p)
    want_x = icm._binary_icm(x0, *p[1:])
    x, u0, u1, t8, trip, _, _, p4, pairs = p
    assert torch.equal(xs, want_x)
    assert torch.equal(es, icm.binary_energy(want_x, u0, u1, t8, trip, p4,
                                             pairs))
    assert icm.SEAM.tally == dict(kernel=0, twin=1, largest=0)


def _bad(name):
    """A problem (group form, so both table kinds are present) with one
    argument made unacceptable to the kernel, and the error expected."""
    x, u0, u1, t8, trip, tables, passes, p4, pairs = _problem("group")
    meta = torch.device("meta")
    if name == "dtype":
        u0 = u0.double()
        err = TypeError
    elif name == "int32_starts":
        x = x.int()
        err = TypeError
    elif name == "device":
        t8 = t8.to(meta)
        err = ValueError
    elif name == "non_contiguous":
        p4 = p4.t().contiguous().t()
        err = ValueError
    elif name == "columns":
        t8 = t8[:, :4].contiguous()
        err = ValueError
    elif name == "rows":
        pairs = pairs[1:].contiguous()
        err = ValueError
    elif name == "nodes":
        u1 = u1[1:].contiguous()
        err = ValueError
    elif name == "no_flat_colours":
        tables = tables._replace(color_offsets=tables.color_offsets[:-1])
        err = ValueError
    else:
        raise AssertionError(name)
    return (x, u0, u1, t8, trip, tables, passes, p4, pairs), err


@pytest.mark.parametrize("name", ["dtype", "int32_starts", "device",
                                  "non_contiguous", "columns", "rows",
                                  "nodes", "no_flat_colours"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(name):
    (x, u0, u1, t8, trip, tables, passes, p4, pairs), err = _bad(name)
    with pytest.raises(err):
        icm.check(x, u0, u1, t8, trip, tables, p4, pairs)


@pytest.mark.parametrize("form", FORMS)
def test_the_real_arguments_pass_the_check(form):
    p = _problem(form)
    icm.check(*p[:6], p[7], p[8])


def test_tensors_on_neither_cpu_nor_cuda_raise_and_nothing_falls_back():
    """CPU tensors run the twin at the wrapper; a device the kernel does
    not serve (meta) raises there, with no fallback to the plain version,
    and counts nothing."""
    p = _problem("t8")
    x0 = p[0].clone()
    xs, es = icm.icm_binary(*p)
    want = icm.icm_binary_twin(x0, *p[1:])
    assert torch.equal(xs, want[0]) and torch.equal(es, want[1])
    meta = [t.to("meta") if isinstance(t, torch.Tensor) else t for t in p]
    before = dict(icm.SEAM.tally)
    with trace.run(None, "cpu", on=True):
        with trace.span("fusion") as span:
            with pytest.raises(ValueError, match="unsupported device"):
                icm.icm_binary(*meta)
    assert span.counters == {}
    assert icm.SEAM.tally == before


def _flat_equal(tables):
    ids = tables.color_ids.numpy()
    offsets = tables.color_offsets.numpy()
    assert tables.color_ids.dtype == tables.color_offsets.dtype == torch.int32
    assert offsets[0] == 0 and offsets[-1] == len(ids)
    assert len(offsets) == len(tables.groups) + 1
    np.testing.assert_array_equal(
        ids, np.concatenate([g.numpy() for g in tables.groups]))
    for c, g in enumerate(tables.groups):
        np.testing.assert_array_equal(ids[offsets[c]:offsets[c + 1]],
                                      g.numpy())


@pytest.mark.parametrize("which", ["triplets", "pairs", "group",
                                   "group_converged", "converted"])
def test_flat_colour_table_is_the_concatenated_groups(which):
    """The flat table and offsets K2 reads, as the pairwise fusion tables
    (triplet and pair colourings), the group iteration tables and the
    tables converted from the JAX package build them."""
    m = Mesh.from_icosphere(2)
    faces = np.sort(m.faces.astype(np.int64), axis=1)
    K = m.nvertices
    if which == "triplets":
        tables = FU.build_fusion_tables(faces, K, "cpu")
    elif which == "pairs":
        tables = FU.build_fusion_tables(np.zeros((0, 3), np.int64), K, "cpu",
                                        pairs=icm_bench._edges(faces))
    elif which.startswith("group"):
        S = 4
        rng = np.random.default_rng(3)
        partner = (np.broadcast_to(np.arange(K), (S, S, K)).copy()
                   if which == "group_converged"
                   else rng.integers(0, K, (S, S, K)))
        tables = GF.build_iteration_tables(partner, faces, S, K, "cpu")
    else:
        from newmsm_tpu.reg.optimise import fusion as JFU
        tables = convert.fusion_tables(JFU.build_fusion_tables(faces, K),
                                       "cpu")
    _flat_equal(tables)


def _spans(path):
    return [e for e in map(json.loads, open(path)) if e["event"] == "span"]


def _count(span, name):
    c = span["counters"].get(name, 0)
    return c["n"] if isinstance(c, dict) else c


def _pair_config():
    cfg = RegConfig()
    cfg.cost = ["DISCRETE"]
    cfg.simval = [2]
    cfg.iters = [2]
    cfg.sigma_in = [0.0]
    cfg.sigma_ref = [0.0]
    cfg.reglambda = [0.1]
    cfg.datagrid = [3]
    cfg.cpgrid = [1]
    cfg.sampgrid = [3]
    cfg.anatgrid = [3]
    cfg.mciters = [50]
    cfg.dopt = "HOCR"
    cfg.regmode = 3
    return cfg


def test_a_traced_cpu_registration_counts_one_twin_a_fusion_move(
        tmp_path, monkeypatch):
    """register_dataset on the CPU with the driver's metrics on: every
    `fusion` span holds as many `icm.twin` counts as `fusion.move` marks,
    and no `icm.kernel`."""
    from newmsm_tpu_torch.eval.synth import synth_cohort
    from newmsm_tpu_torch.pipelines.cohort import register_dataset
    from newmsm_tpu_torch.reg.driver import MeshRegistration
    path = str(tmp_path / "metrics.jsonl")
    init = MeshRegistration.__init__

    def with_metrics(self, *a, **k):
        init(self, *a, **k)
        self.metrics_path = path
    monkeypatch.setattr(MeshRegistration, "__init__", with_metrics)
    _, datasets, template_data = synth_cohort(3, 1, seed=0)
    res = register_dataset(["s"], Mesh.from_icosphere(3), template_data,
                           _pair_config(), {"s": datasets[0]},
                           outdir=str(tmp_path) + "/", device="cpu")
    assert not res.failed, res.failed
    fusion = [s for s in _spans(path) if s["name"] == "fusion"]
    assert fusion
    for s in fusion:
        assert _count(s, "fusion.move") > 0
        assert _count(s, "icm.twin") == _count(s, "fusion.move")
        assert "icm.kernel" not in s["counters"]


def test_a_traced_cpu_cohort_counts_one_twin_an_alpha_step(tmp_path,
                                                           monkeypatch):
    """run_gmsm on the CPU, 2 subjects at ico-3: the `opt` and
    `group.regrow` spans hold one `icm.twin` a `group.alpha` mark, and no
    `icm.kernel`."""
    from newmsm_tpu_torch.eval.synth import synth_cohort
    from newmsm_tpu_torch.pipelines.gmsm import run_gmsm
    meshes, datasets, _ = synth_cohort(3, 2, seed=1)
    cfg = _pair_config()
    cfg.sigma_in = cfg.sigma_ref = [0.0]
    path = str(tmp_path / "group.jsonl")
    monkeypatch.chdir(tmp_path)
    template = Mesh.from_icosphere(3)
    template.true_rescale(100.0)
    run_gmsm(meshes, datasets, template, cfg, device="cpu",
             metrics_path=path)
    spans = [s for s in _spans(path) if s["name"] in ("opt", "group.regrow")]
    assert spans
    alphas = sum(_count(s, "group.alpha") for s in spans)
    assert alphas > 0
    assert sum(_count(s, "icm.twin") for s in spans) == alphas
    assert not any("icm.kernel" in s["counters"] for s in spans)
    ranks = [json.loads(line) for line in open(path)
             if json.loads(line)["event"] == "ranks"]
    assert len(ranks) == 1 and ranks[0]["icm_launches"] == [0]


def test_kernel_source_and_build_command():
    src = _build.CSRC_DIR / icm.SOURCE
    text = src.read_text()
    assert 'extern "C" int icm_binary_launch' in text
    assert "Replaces no TPU kernel" in text
    assert "__global__ void __cluster_dims__" in text
    assert icm.KERNEL in text
    cmd = _build.nvcc_command(src, pathlib.Path("x.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1] == str(src) and cmd[cmd.index("-o") + 1] == "x.so"
    lib = _build.library_path(icm.SOURCE)
    assert lib.parent == ROOT / "build" / "newmsm_tpu_torch"
    assert lib.name.startswith("icm_binary_") and lib.suffix == ".so"


@pytest.mark.parametrize("asked", ["locate_bary.cu", icm.SOURCE,
                                   "rigid_cost.cu"])
def test_one_build_builds_every_csrc_source(asked, tmp_path, monkeypatch):
    """Asked for one csrc/ source, _build compiles every csrc/ source whose
    library is missing (so that no nvcc runs inside a timed window), and a
    second ask compiles nothing; a source outside csrc/ builds alone."""
    calls = []

    def fake_run(cmd, capture_output, text):
        out = pathlib.Path(cmd[cmd.index("-o") + 1])
        out.write_bytes(b"")
        calls.append(pathlib.Path(cmd[-1]).name)

        class Done:
            returncode, stdout, stderr = 0, "ptxas info\n", ""
        return Done()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_cuda_tool", lambda tool="nvcc": tool)
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    lib = _build.build(asked)
    every = sorted(p.name for p in _build.CSRC_DIR.glob("*.cu"))
    assert {"locate_bary.cu", icm.SOURCE, "rigid_cost.cu"} <= set(every)
    assert sorted(calls) == every
    assert lib == _build.library_path(asked) and lib.exists()
    assert all(_build.library_path(s).with_suffix(".log").exists()
               for s in every)
    _build.build(asked)
    assert sorted(calls) == every
    own = tmp_path / "other.cu"
    own.write_text("// another kernel\n")
    _build.build(own)
    assert calls[-1] == "other.cu" and len(calls) == len(every) + 1


@pytest.mark.parametrize("asked", ["locate_bary.cu", icm.SOURCE,
                                   "rigid_cost.cu"])
def test_a_build_at_other_flags_builds_the_asked_source_alone(
        asked, tmp_path, monkeypatch):
    """Other flags than NVCC_FLAGS (a variant build of a bench or a SASS
    read) compile only the source asked for."""
    calls = []

    def fake_run(cmd, capture_output, text):
        pathlib.Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        calls.append(pathlib.Path(cmd[-1]).name)

        class Done:
            returncode, stdout, stderr = 0, "", ""
        return Done()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_cuda_tool", lambda tool="nvcc": tool)
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    flags = _build.NVCC_FLAGS + ("-lineinfo",)
    lib = _build.build(asked, flags)
    assert calls == [asked]
    assert lib == _build.library_path(asked, flags) and lib.exists()


def test_load_takes_the_mark_of_its_caller():
    """The generic loader names no kernel: its trace mark is the
    caller's."""
    with pytest.raises(TypeError):
        _build.load(icm.SOURCE)


@pytest.mark.parametrize("form", FORMS)
def test_floor_problems_keep_the_chain_and_drop_the_work(form):
    """The floors of the card's timing: the same colour count and passes,
    no tables; 'barrier' with every colour group empty, 'gather' with the
    problem's groups. Both pass the wrapper's check."""
    problem = _problem(form)
    floors = icm_bench.floor_problems(problem)
    assert set(floors) == {"barrier", "gather"}
    tables = problem[5]
    for name, p in floors.items():
        x, u0, u1, t8, trip, t, passes, p4, pairs = p
        assert t8 is None and trip is None and p4 is None and pairs is None
        assert x is problem[0] and passes == problem[6]
        assert len(t.groups) == len(tables.groups)
        assert t.color_offsets.shape == tables.color_offsets.shape
        assert icm_bench.barrier_chain(p) == icm_bench.barrier_chain(problem)
        icm.check(x, u0, u1, t8, trip, t, p4, pairs)
    assert floors["barrier"][5].color_ids.numel() == 0
    assert not floors["barrier"][5].color_offsets.any()
    assert torch.equal(floors["gather"][5].color_ids, tables.color_ids)
    assert torch.equal(floors["gather"][5].color_offsets,
                       tables.color_offsets)


def _span(counters):
    return {"event": "span", "name": "fusion", "counters": counters}


def _ranks(icm_launches, locate=(7,), rigid=(4,), labelmap=(2,)):
    n = len(icm_launches)
    return [{"locate": {"kernel": k1, "twin": 0, "largest": 9},
             "icm": {"kernel": k2, "twin": 0, "largest": 9},
             "rigid": {"kernel": k3, "twin": 0, "largest": 9},
             "labelmap": {"kernel": k4, "twin": 0, "largest": 9}}
            for k1, k2, k3, k4 in zip(locate * n, icm_launches, rigid * n,
                                      labelmap * n)]


@pytest.mark.parametrize("case", ["one_rank", "by_rank", "short_rank",
                                  "twin", "no_kernel_count", "k1_count",
                                  "k1_twin", "k3_short", "k4_count",
                                  "k4_twin", "k4_uneven_spans"])
def test_chip_smoke_holds_each_path_to_one_launch_a_move(case):
    """chip_smoke.check_kernels: each rank's K2 launches equal the run's
    move marks, the spans count as many `icm.kernel` and no `icm.twin`;
    rank 0's K1 launches equal the `locate.kernel` counts, with no
    `locate.twin`; K3 launches once a `cost_evals` count; K4 launches
    equal the `labelmap.kernel` counts, the same in every `group.maps`
    span, with no `labelmap.twin`; anything else fails the smoke run."""
    import chip_smoke
    maps = [1, 0 if case == "k4_uneven_spans" else 1]
    events = [{"event": "iter"},
              _span({"fusion.move": {"n": 3, "s": 0.1}, "icm.kernel": 3,
                     "locate.kernel": 4, "cost_evals": 4,
                     "rigid.kernel": 4}),
              _span({"fusion.move": {"n": 2, "s": 0.1}, "icm.kernel": 2,
                     "locate.kernel": 3})]
    events += [{"event": "span", "name": "group.maps",
                "counters": {"labelmap.kernel": m} if m else {}}
               for m in maps]
    if case == "k4_uneven_spans":
        events[-2]["counters"]["labelmap.kernel"] = 2
    if case == "k4_twin":
        events.append(_span({"labelmap.twin": 1}))
    launches = {"one_rank": [5], "by_rank": [5, 5],
                "short_rank": [5, 4]}.get(case, [5])
    if case == "twin":
        events.append(_span({"icm.twin": 1}))
    if case == "no_kernel_count":
        del events[1]["counters"]["icm.kernel"]
    if case == "k1_twin":
        events.append(_span({"locate.twin": 1}))
    ranks = _ranks(launches, locate=(8 if case == "k1_count" else 7,),
                   rigid=(3 if case == "k3_short" else 4,),
                   labelmap=(3 if case == "k4_count" else 2,))
    assert chip_smoke.span_total(events, "fusion.move") == 5
    if case in ("one_rank", "by_rank"):
        chip_smoke.check_kernels("path", ranks, events, "fusion.move")
    else:
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.check_kernels("path", ranks, events, "fusion.move")
