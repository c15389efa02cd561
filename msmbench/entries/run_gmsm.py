"""Entry `run_gmsm`: one gMSM cohort a unit through the program's
`pipelines.gmsm.run_gmsm` (groupwise registration, lift to the native
spheres, dedrift, resampling to the template, mean / stdev maps and
statistics), in one process, as `run_cgmsm` runs group after group.
Warm-up: cohorts of other subjects with the traffic's warm-up options
(shorter iteration counts)."""
from __future__ import annotations

import numpy as np

from msmbench import harness
from msmbench.entry import Entry as Base
from msmbench.inputs import Inputs
from msmbench.reference import judge


class Entry(Base):

    def setup(self):
        t = self.traffic
        self.S = int(t["subjects_per_unit"])
        self.inputs = Inputs(t, self.seed)
        self.template = self.inputs.mesh()
        warm_conf = self.conf_with(t["warmup"].get("options", {}),
                                   "warmup.conf")
        for k, sids in enumerate(self.inputs.warm if self.warm_up
                                 else []):
            self._run(sids, warm_conf, self.out(f"warm{k}"))
        self.sync()

    def capacity(self):
        return len(self.inputs.units)

    def _run(self, sids, conf, outdir, metrics=None):
        from newmsm_tpu_torch.pipelines.gmsm import run_gmsm
        return run_gmsm([self.inputs.mesh() for _ in sids],
                        [self.inputs.data[s] for s in sids], self.template,
                        conf, outdir=outdir, device=self.device,
                        metrics_path=metrics)

    def driver_class(self):
        from newmsm_tpu_torch.reg.group import GroupMeshRegistration
        return GroupMeshRegistration

    def run_unit(self, i):
        sids = self.inputs.units[i % self.capacity()]
        outdir = self.out(f"c{i}")
        metrics = outdir + "metrics.jsonl" if self.trace else None
        unit = {"subjects": self.S, "sids": sids, "outdir": outdir}
        try:
            res = self._run(sids, str(self.conf_path), outdir, metrics)
            self.sync()
            unit.update(failed=0, result={
                "dedrifted": [m.coords for m in res.dedrifted_spheres],
                "resampled": [np.asarray(r) for r in res.resampled_data],
                "mean": res.mean_map, "stdev": res.stdev_map,
                "stats": dict(res.stats)})
        except (RuntimeError, ValueError) as e:
            unit.update(failed=self.S, error=repr(e))
        self.units.append(unit)
        return unit

    def _outputs(self, unit) -> dict:
        from newmsm_tpu_torch.core.mesh import Mesh
        c = {"sids": unit["sids"], "coords": self.inputs.coords,
             "faces": self.inputs.faces,
             "data": [self.inputs.data[s] for s in unit["sids"]]}
        if "result" not in unit:
            return dict(c, missing=True)
        try:
            c["registered"] = [
                Mesh.load(f"{unit['outdir']}sphere-{s}.reg.surf.gii").coords
                for s in range(len(unit["sids"]))]
        except (OSError, ValueError):
            return dict(c, missing=True)
        c.update(unit["result"])
        return c

    def judge(self, control=False):
        cohorts = [self._outputs(u) for u in self.units]
        template = self.inputs.template()
        if control:
            for c in cohorts:
                if not c.get("missing"):
                    c.update(judge.control_cohort(c, template, self.device))
        return judge.judge_cohorts(cohorts, template, self.device,
                                   self.cell.bands)

    def layer_events(self):
        return [harness.read_jsonl(u["outdir"] + "metrics.jsonl")
                for u in self.units]
