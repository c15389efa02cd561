"""Entry `register_dataset`: subjects registered to the template one after
another in one process, each through one call of the program's
`pipelines.cohort.register_dataset` (distortion written), as a
registration-to-template batch job runs (newMSM_HCP_to_template_v2.sh).
Warm-up: whole registrations of subjects the window does not see."""
from __future__ import annotations


from msmbench import harness
from msmbench.entry import Entry as Base
from msmbench.inputs import Inputs
from msmbench.reference import judge


class Entry(Base):

    def setup(self):
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

    def capacity(self):
        return len(self.inputs.units)

    def _register(self, sid, outdir):
        from newmsm_tpu_torch.pipelines.cohort import register_dataset
        return register_dataset([str(sid)], self.mesh,
                                self.inputs.template_data,
                                str(self.conf_path),
                                {str(sid): self.inputs.data[sid]},
                                outdir=outdir, device=self.device)

    def driver_class(self):
        from newmsm_tpu_torch.reg.driver import MeshRegistration
        return MeshRegistration

    def run_unit(self, i):
        (sid,) = self.inputs.units[i % self.capacity()]
        outdir = self.out(f"u{i}")
        if self.trace:
            self.metrics_file = outdir + "metrics.jsonl"
        result = self._register(sid, outdir)
        self.sync()
        stats = result.per_subject.get(str(sid))
        self.units.append({"subjects": 1, "failed": int(stats is None),
                           "sid": sid, "outdir": outdir, "stats": stats,
                           "error": result.failed.get(str(sid))})
        return self.units[-1]

    def _outputs(self, unit) -> dict:
        from newmsm_tpu_torch.core import io as mio
        from newmsm_tpu_torch.core.mesh import Mesh
        s = self.inputs.subject(unit["sid"])
        prefix = f"{unit['outdir']}{unit['sid']}.MSM."
        try:
            s["reg_coords"] = Mesh.load(prefix + "sphere.reg.surf.gii").coords
            s["transformed"] = mio.load_data(
                prefix + "transformed_and_reprojected.func.gii", self.mesh)
        except (OSError, ValueError):
            s["reg_coords"] = s["transformed"] = None
        s["stats"] = unit["stats"]
        return s

    def judge(self, control=False):
        subjects = [self._outputs(u) for u in self.units]
        template = self.inputs.template()
        if control:
            for s in subjects:
                if s["reg_coords"] is not None:
                    s.update(judge.control_pairwise(s, template, self.device))
        return judge.judge_pairwise(subjects, template, self.device,
                                    self.cell.bands)

    def layer_events(self):
        return [harness.read_jsonl(u["outdir"] + "metrics.jsonl")
                for u in self.units]

