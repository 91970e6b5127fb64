"""K3, `kernels/search.cu` neighbourhood lookup (`neighborhood_kernel`):
the candidate gather of every ICP scan. Least traffic per lane: the
queries, flags, pose and origin, the table's keys once, base and n_present
out; each present row (RW 4-byte lanes) read and written once.
Operations: per query column 24 plus one per binary-search step."""

KERNEL = "neighborhood_kernel"


def bytes_ops(Q: int, B: int, C: int, RW: int, present: float, **_):
    steps = int(C).bit_length()
    n_bytes = B * (13.0 * Q + 60 + 4.0 * C + 8.0 * 9 * Q) + 2.0 * 4 * RW * present
    return n_bytes, B * 9.0 * Q * (24 + steps)
