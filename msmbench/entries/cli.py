"""Entry `cli`: each subject a fresh `python -m newmsm_tpu_torch.cli ...
--device cuda` process on GIFTI files written in set-up, as a SLURM array
task of the reference's one-process-a-subject pattern runs it. Every unit
pays interpreter start-up, imports, the CUDA context and the cold host
tables. Set-up writes the files and builds the kernel library (the one
build a checkout ever does), so nothing compiles in the window. A traced
run passes the CLI its own `--metrics` on every unit, and after the window
profiles one more subject's last level in a fresh process. Each process
runs the CLI through msmbench/cli_child.py, which reports the process's
own peak of device memory; this process never opens the card during the
window."""
from __future__ import annotations

import subprocess
import sys

from msmbench import harness
from msmbench.entry import Entry as Base
from msmbench.inputs import Inputs
from msmbench.reference import judge


class Entry(Base):

    def setup(self):
        from newmsm_tpu_torch.core.mesh import Mesh
        from newmsm_tpu_torch.ops import _build, locate
        self.inputs = Inputs(self.traffic, self.seed)
        self.sphere = str(self.workdir / "sphere.surf.gii")
        mesh = self.inputs.mesh()
        mesh.data = None
        mesh.save(self.sphere)
        self.template_file = str(self.workdir / "template.func.gii")
        Mesh(coords=mesh.coords, faces=mesh.faces,
             data=self.inputs.template_data).save(self.template_file)
        self.files = {}
        for sid in self.inputs.data:
            self.files[sid] = str(self.workdir / f"{sid}.func.gii")
            Mesh(coords=mesh.coords, faces=mesh.faces,
                 data=self.inputs.data[sid]).save(self.files[sid])
        if self.device.type == "cuda":
            _build.build(locate.SOURCE)
        self.mesh = mesh
        self.peak = 0

    def capacity(self):
        return len(self.inputs.units)

    def _child(self, i, traced=False) -> dict:
        """Unit i in a fresh process; returns what cli_child.py wrote, or
        {} when the process failed."""
        (sid,) = self.inputs.units[i % self.capacity()]
        out = self.out(f"u{i}")
        summary = out + "child.json"
        cmd = [sys.executable, str(harness.HERE / "cli_child.py"), summary,
               *(["--trace"] if traced else []), "--",
               *self._cli_args(sid, out)]
        proc = subprocess.run(cmd, cwd=harness.ROOT, capture_output=True,
                              text=True)
        self.units.append({"subjects": 1, "failed": int(proc.returncode != 0),
                           "sid": sid, "outdir": out,
                           "error": proc.stderr[-2000:] if proc.returncode
                           else None})
        if proc.returncode:
            return {}
        got = harness.load_json(summary)
        self.peak = max(self.peak, got["peak_bytes"])
        return got

    def run_unit(self, i):
        self._child(i)
        return self.units[-1]

    def profile_unit(self, i, trace):
        """Unit i once more, in a fresh process with the last level of the
        registration under the profiler (the CLI's own --profile would
        export the whole run's trace to disk)."""
        got = self._child(i, traced=True)
        if not got:
            return None, []
        return got["summary"], [tuple(c) for c in got["k1_calls"]]

    def _cli_args(self, sid, out):
        args = ["--inmesh", self.sphere, "--refmesh", self.sphere,
                "--indata", self.files[sid], "--refdata", self.template_file,
                "-o", out, "--conf", str(self.conf_path),
                "--device", self.device.type]
        if self.trace:
            args += ["--metrics", out + "metrics.jsonl"]
        return args

    def peak_bytes(self):
        return self.peak

    def _outputs(self, unit) -> dict:
        from newmsm_tpu_torch.core import io as mio
        from newmsm_tpu_torch.core.mesh import Mesh
        s = self.inputs.subject(unit["sid"])
        try:
            s["reg_coords"] = Mesh.load(unit["outdir"]
                                        + "sphere.reg.surf.gii").coords
            s["transformed"] = mio.load_data(
                unit["outdir"] + "transformed_and_reprojected.func.gii",
                self.mesh)
        except (OSError, ValueError):
            s["reg_coords"] = s["transformed"] = None
        return s

    def judge(self, control=False):
        subjects = [self._outputs(u) for u in self.units]
        template = self.inputs.template()
        if control:
            for s in subjects:
                if s["reg_coords"] is not None:
                    low = judge.control_pairwise(s, template, self.device)
                    s["transformed"] = low["transformed"]
        return judge.judge_pairwise(subjects, template, self.device,
                                    self.cell.bands)

    def layer_events(self):
        return [harness.read_jsonl(u["outdir"] + "metrics.jsonl")
                for u in self.units]
