"""subject_post_s.pair: seconds a subject of register_dataset's work after
the registration (pipelines/cohort.py: distortion, CC, the distortion
file): the `subject.post` span."""
from msmbench import spans


def read(ctx):
    return spans.wall_per_subject(ctx, "subject.post")
