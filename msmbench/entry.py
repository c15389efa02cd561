"""What every entry (msmbench/entries/<name>.py, named by a traffic mix's
`entry`) provides to the harness. An entry drives one of the program's
entry points: it makes its inputs, warms up, runs one unit (one
subject's or one cohort's registration) at a time, and afterwards hands
the reference what the units produced."""
from __future__ import annotations

import os
import pathlib


class Entry:
    """cell: harness.Cell; seed: --seed; device: the card (a torch device);
    workdir: where outputs go (under TMPDIR); trace: --trace 1."""

    def __init__(self, cell, seed: int, device, workdir, trace: bool):
        self.cell = cell
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.device = device
        self.workdir = pathlib.Path(workdir)
        self.trace = trace
        self.units: list = []       # per unit: subjects, failed, outputs
        self.hooks: list = []       # removers of hooks put on the program
        self.warm_up = True         # run the traffic's warm-up in setup()
        self.conf_path = self.workdir / "config.conf"
        self.conf_path.write_text(cell.config_text())

    def conf_with(self, options: dict, name: str) -> str:
        """A configuration file with some options changed (the warm-up's
        shorter iteration counts); returns its path."""
        text = "".join(
            line if not any(line.startswith(f"--{k}=") for k in options)
            else "" for line in self.cell.config_text().splitlines(True))
        text += "".join(f"--{k}={v}\n" for k, v in options.items())
        path = self.workdir / name
        path.write_text(text)
        return str(path)

    def sync(self) -> None:
        """Wait for the device's queued work."""
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def out(self, name: str) -> str:
        path = self.workdir / name
        os.makedirs(path, exist_ok=True)
        return str(path) + "/"

    # the harness calls these, in this order
    def setup(self) -> None:
        raise NotImplementedError

    def capacity(self) -> int:
        """Units the window can run: the traffic's pool of units (the
        profiled unit after the window repeats one of them)."""
        raise NotImplementedError

    def run_unit(self, i: int) -> dict:
        """Run unit i to its end (device work finished); returns
        {"subjects": attempted, "failed": n}. In a traced run the program
        writes its metrics events for every unit."""
        raise NotImplementedError

    def driver_class(self):
        """The program's driver class whose last level the profiler
        holds."""
        raise NotImplementedError

    def profile_unit(self, i: int, trace) -> tuple:
        """Traced runs, after the window: one more unit (the inputs of unit
        i modulo the pool) with the last level of its registration under
        the profiler (a
        harness.DeviceTrace). Returns (the trace's reduction, K1's calls in
        it)."""
        from . import harness
        remove = harness.level_trace(self.driver_class(), trace,
                                     lambda d: d.cfg.levels - 1)
        try:
            self.run_unit(i)
        finally:
            remove()
        return trace.summary, list(trace.k1.calls)

    def peak_bytes(self) -> int:
        import torch
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def release(self) -> None:
        """Free the program's device state before the reference runs."""
        import gc
        import torch
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self) -> None:
        """Take off every hook this entry put on the program's classes."""
        while self.hooks:
            self.hooks.pop()()

    def judge(self, control: bool = False) -> dict:
        """The compared numbers of every unit the window ran (the
        reference's control in the program's place when `control`)."""
        raise NotImplementedError

    def layer_events(self) -> list:
        """Per unit the program's metrics events (traced runs)."""
        return [u.get("events", []) for u in self.units]
