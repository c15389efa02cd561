"""cli_start_s.pair: seconds a subject of the CLI's start-up after its
arguments are parsed (cli.py: the driver's imports, the CUDA context,
K1's library, the GIFTI inputs): the `cli.start` span."""
from msmbench import spans


def read(ctx):
    return spans.wall_per_subject(ctx, "cli.start")
