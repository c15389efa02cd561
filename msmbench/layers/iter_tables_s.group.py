"""iter_tables_s.group: seconds a subject of the group iteration's tables
(reg/group.py: the partner search, its read to the host and
`build_iteration_tables`): the `group.iter_tables` spans."""
from msmbench import spans


def read(ctx):
    return spans.wall_per_subject(ctx, "group.iter_tables")
