"""label_maps_s.group: seconds a subject of the group driver's label maps
(the label-deformed template maps, reg/group.py `_maps_fn`): the
`group.maps` spans."""
from msmbench import spans


def read(ctx):
    return spans.wall_per_subject(ctx, "group.maps")
