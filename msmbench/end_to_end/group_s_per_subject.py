"""group_s_per_subject: card seconds a subject of a gMSM cohort run (the
whole run_gmsm: registration, lift, dedrift, resampling, statistics), the
window's time up to the end of its last cohort over the subjects it
completed."""


def read(run) -> float:
    return run["window"].seconds_per_subject(run["completed"])
