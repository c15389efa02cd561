"""pair_s_per_subject: wall seconds a subject registered to the template,
the window's time up to the end of its last unit over the subjects it
completed."""


def read(run) -> float:
    return run["window"].seconds_per_subject(run["completed"])
