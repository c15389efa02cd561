#!/usr/bin/env python3
"""One run of the program's CLI in this process, for the CLI entry
(msmbench/entries/cli.py):

    python3 msmbench/cli_child.py SUMMARY.json [--trace] -- <newmsm_tpu_torch.cli args>

writes {"rc", "peak_bytes"} to SUMMARY.json and exits with the CLI's code:
`peak_bytes` is this process's own peak of device memory allocated through
torch (so nothing another process holds on the card counts). With
--trace, the last level of the registration runs under the profiler,
reduced in memory, and the file also holds "summary"
(harness.reduce_events) and "k1_calls".
"""
from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from msmbench import harness  # noqa: E402


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cut = argv.index("--")
    out, traced, rest = argv[0], "--trace" in argv[1:cut], argv[cut + 1:]
    import torch
    from newmsm_tpu_torch import cli
    from newmsm_tpu_torch.reg.driver import MeshRegistration
    got: dict = {}
    k1 = harness.K1Recorder()
    trace = harness.DeviceTrace(k1)
    remove = lambda: None  # noqa: E731
    if traced:
        k1.install()
        remove = harness.level_trace(MeshRegistration, trace,
                                     lambda mr: mr.cfg.levels - 1)
    try:
        rc = cli.main(rest)
    finally:
        remove()
        k1.uninstall()
    got["rc"] = rc
    got["peak_bytes"] = int(torch.cuda.max_memory_allocated()) \
        if torch.cuda.is_available() else 0
    if traced:
        got.update(summary=trace.summary, k1_calls=k1.calls)
    with open(out, "w") as f:
        json.dump(got, f)
    return rc


if __name__ == "__main__":
    sys.exit(main())
