"""peak_mem_gib.pair: the most device memory the program held in the
window (torch.cuda.max_memory_allocated), GiB."""
from msmbench import layerlib


def read(ctx):
    return layerlib.peak_mem_gib(ctx)
