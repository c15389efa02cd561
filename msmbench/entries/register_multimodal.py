"""Entry `register_multimodal`: the `register_dataset` entry on subjects
with many channels a vertex, from the frozen multimodal generator
(msmbench/synth_multimodal.py), as an MSMAll batch job registers each
subject's myelin and resting-state maps to a group template.

Besides the outputs, each unit keeps the last (T,8) call of the
program's triclique likelihood (`reg.costs.triclique_likelihood`, hooked
through its module attribute, which the program's model calls): its
inputs and its output, by reference, with no copy and no sync inside the
unit. The judge recomputes that call with the plain reference."""
from __future__ import annotations

import inspect

from msmbench import harness
from msmbench import synth_multimodal as SM
from msmbench.inputs import Inputs as PairwiseInputs
from msmbench.reference import judge
from msmbench.reference import judge_multimodal

Base = harness.load_module(harness.HERE / "entries" / "register_dataset.py",
                           "register_dataset").Entry


class Inputs(PairwiseInputs):
    """PairwiseInputs with `len(traffic["channels"])` channels a vertex:
    template_data (D,N), data[sid] (D,N)."""

    def __init__(self, traffic: dict, seed: int):
        self.res = res = traffic["subject_res"]
        n_channels = len(traffic["channels"])
        self.coords, self.faces = SM.icosphere(res)
        self.template_data = SM.template_data(res, n_channels)
        self.warm, self.units = SM.arrange(
            traffic["pool_seed"], seed, traffic["subjects_per_unit"],
            traffic["warmup"]["units"], traffic["units"])
        self.data = {sid: SM.subject_data(res, sid, n_channels)
                     for unit in self.warm + self.units for sid in unit}


def likelihood_hook(keep):
    """Wrap the program's triclique likelihood so that `keep(args, kwargs,
    out)` sees every (T,8) call. Returns the function that takes the hook
    off."""
    from newmsm_tpu_torch.reg import costs
    orig = costs.triclique_likelihood

    def recorded(*args, **kwargs):
        out = orig(*args, **kwargs)
        if out.dim() == 2 and out.shape[1] == 8:
            keep(args, kwargs, out)
        return out

    costs.triclique_likelihood = recorded

    def remove():
        costs.triclique_likelihood = orig
    return remove


def call_record(signature, args, kwargs, out) -> dict:
    """The kept call as the reference takes it (judge_multimodal)."""
    a = signature.bind(*args, **kwargs)
    a.apply_defaults()
    p = a.arguments
    tables = p["tables"]
    return {"cp": p["cp_coords"], "rl": p["rl"],
            "triplets": tables.triplets, "face_idx": p["face_idx"],
            "face_mask": p["face_mask"], "src": p["src_coords"],
            "abs_weights": p["abs_weights"], "cfweights": p["cfweights"],
            "source_data": tables.source_data,
            "target_data": tables.target_data,
            "target_res": int(tables.target_tables.pristine_res),
            "la": p["la"], "lb": p["lb"], "lc": p["lc"],
            "simval": int(p["simval"]),
            "multivariate": bool(p["multivariate"]), "out": out}


class Entry(Base):

    def setup(self):
        from newmsm_tpu_torch.reg import costs
        self.signature = inspect.signature(costs.triclique_likelihood)
        self.last_call = None
        self.hooks.append(likelihood_hook(self._keep))
        self.inputs = Inputs(self.traffic, self.seed)
        self.mesh = self.inputs.mesh()
        self.metrics_file = None
        for k, (sid,) in enumerate(self.inputs.warm if self.warm_up else []):
            self._register(sid, self.out(f"warm{k}"))
        self.sync()
        if self.trace:
            from newmsm_tpu_torch.reg.driver import MeshRegistration
            self.hooks.append(harness.driver_metrics(
                MeshRegistration, lambda: self.metrics_file))

    def _keep(self, args, kwargs, out):
        self.last_call = (args, kwargs, out)

    def run_unit(self, i):
        self.last_call = None
        unit = super().run_unit(i)
        unit["lik"], self.last_call = self.last_call, None
        return unit

    def judge(self, control=False):
        subjects = [self._outputs(u) for u in self.units]
        template = self.inputs.template()
        if control:
            for s in subjects:
                if s["reg_coords"] is not None:
                    s.update(judge.control_pairwise(s, template, self.device))
        liks = [None if u.get("lik") is None
                else call_record(self.signature, *u["lik"])
                for u in self.units]
        return judge_multimodal.judge_multimodal(
            subjects, template, self.device, self.cell.bands, liks, control)
