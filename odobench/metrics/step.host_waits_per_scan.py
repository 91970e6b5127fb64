"""The step's waits on the device per scan over the window: the port's
`HostFlags.waits` counter."""


def read(ctx):
    waits = ctx.counters.get("host_waits")
    if waits is None or not ctx.scans:
        return None
    return waits / ctx.scans
