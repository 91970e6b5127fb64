"""Device operations (kernels, copies, sets) in the traced span, per scan
(per step of all lanes in a fleet)."""


def read(ctx):
    if not ctx.trace or not ctx.traced:
        return None
    return ctx.trace[0].device_ops / ctx.traced["scans"]
