"""Milliseconds per scan (per step of all lanes in a fleet) in which a
device operation ran, in the traced span: the union of the operations'
intervals, so overlapping ones count once; of the busiest rank."""


def read(ctx):
    if not ctx.trace or not ctx.traced:
        return None
    return max(s.busy_s for s in ctx.trace) * 1e3 / ctx.traced["scans"]
