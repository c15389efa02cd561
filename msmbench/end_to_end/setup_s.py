"""setup_s: seconds from the start of the benchmark's process to the
window: imports, the CUDA context, the kernel library, the inputs and the
warm-up."""


def read(run) -> float:
    return run["setup_s"]
