"""host_tables_s.pair: host seconds a subject of building host tables
(the memoised builders of ops/, reg/, core/icosphere.py): the `s` of the
spans' `host_tables` counters, which count only misses; 0 when every
table was found in its cache."""
from msmbench import layerlib, spans


def read(ctx):
    if spans.counter_total(ctx, "host_tables", "s") is None:
        return None
    return layerlib.per_subject(ctx, lambda u: sum(
        s["counters"]["host_tables"]["s"] for s in spans.spans(u)
        if "host_tables" in s["counters"]))
