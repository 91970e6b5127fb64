"""K1, `kernels/match_rows.cu` (`match_kernel`): one re-match of the cached
ICP candidates per round. Least traffic: each present slice's count lane
and its candidates' three coordinates; per lane the queries, their flags,
the pose, n_present and base, and the outputs; a normal per valid match.
Operations: 9 per candidate (distance and compare), 15 per query."""

KERNEL = "match_kernel"


def bytes_ops(Q: int, B: int, present: float, candidates: float, valid: float, **_):
    """Q query slots per lane, B lanes; present slices, candidates and
    valid matches summed over the lanes."""
    n_bytes = (4.0 * (present + 3 * candidates) + B * (Q * 13 + 48 + 2 * 9 * Q * 4 + Q * 33)
               + 12 * valid)
    return n_bytes, 9.0 * candidates + 15.0 * Q * B
