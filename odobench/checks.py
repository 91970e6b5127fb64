"""The check that decides `correct`: what the timed path answered, held to
the plain reference on the same inputs.

The numbers (those named in `limits/<cell>.json` are compared, each with
its limit; the others are printed beside them):
- `pose_gap_m`: the largest distance between an answered position and the
  reference's, over every scan answered in the window;
- `incr_gap_m_p50`, `incr_gap_m_p90`, `incr_gap_m_p99`,
  `incr_gap_m_max`: the gap between the
  answered motion from one scan to the next (in the earlier scan's frame)
  and the reference's, its median, 90th and 99th percentiles and largest over every
  pair of consecutive answered scans; `incr_rot_rad_p50`, `incr_rot_rad_p99`
  the same of the rotation;
- `pose_gap_m_by_drive`: the largest position gap of each drive;
- `map_mismatch`: at each drive's end, the share of voxels that one map
  holds and the other not (|A xor B| / |A or B|), the largest over drives;
- where the program's ICP rounds per scan are known (a fleet's last
  pass), `rounds_differ_share`, the share of scans whose round count
  differs from the reference's, and `incr_gap_share_rounds_differ`, the
  share of the summed motion gaps that falls on those scans.

A position gap carries every earlier scan's gap along the drive, and the
map is built at those positions; the motion from scan to scan does not
accumulate it.
"""

from __future__ import annotations

import numpy as np
import torch

def _keys(x) -> np.ndarray:
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x, np.int64)


def map_mismatch(a, b) -> float:
    a, b = _keys(a), _keys(b)
    return float(np.setxor1d(a, b).size / max(np.union1d(a, b).size, 1))


def _rot(q: np.ndarray) -> np.ndarray:
    """(n, 4) wxyz -> (n, 3, 3)."""
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                     2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                    -1).reshape(-1, 3, 3)


def _angle(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    c = (np.einsum("nij,nij->n", Ra, Rb) - 1.0) / 2.0
    return np.arccos(np.clip(c, -1.0, 1.0))


def _increments(p: np.ndarray):
    """Scan-to-scan motions of poses (n, 7): translations in the earlier
    scan's frame (n-1, 3) and rotations (n-1, 3, 3)."""
    R = _rot(p[:, 3:])
    dt = np.einsum("nji,nj->ni", R[:-1], p[1:, :3] - p[:-1, :3])
    return dt, np.einsum("nji,njk->nik", R[:-1], R[1:])


class Gaps:
    """The gaps of every compared pass, gathered."""

    def __init__(self):
        self.pos, self.inc_t, self.inc_r, self.maps = [], [], [], []
        self.rounds = np.zeros(4)   # scans, scans whose rounds differ, gap there, gap

    def add(self, prog: np.ndarray, ref: np.ndarray, maps=None, rounds=None) -> None:
        """rounds: (the program's, the reference's) ICP rounds per scan."""
        if len(prog) == 0:
            return
        self.pos.append(np.linalg.norm(prog[:, :3] - ref[:, :3], axis=1))
        if len(prog) > 1:
            ta, ra = _increments(prog)
            tb, rb = _increments(ref)
            gap = np.linalg.norm(ta - tb, axis=1)
            self.inc_t.append(gap)
            self.inc_r.append(_angle(ra, rb))
            if rounds is not None:
                differ = np.asarray(rounds[0])[1:len(prog)] != np.asarray(rounds[1])[1:len(prog)]
                self.rounds += [differ.size, differ.sum(), gap[differ].sum(), gap.sum()]
        if maps is not None:
            self.maps.append(map_mismatch(*maps))

    def numbers(self) -> dict:
        pos = np.concatenate(self.pos) if self.pos else np.zeros(1)
        it = np.concatenate(self.inc_t) if self.inc_t else np.zeros(1)
        ir = np.concatenate(self.inc_r) if self.inc_r else np.zeros(1)
        return {"pose_gap_m": float(pos.max()),
                "incr_gap_m_p50": float(np.percentile(it, 50)),
                "incr_gap_m_p90": float(np.percentile(it, 90)),
                "incr_gap_m_p99": float(np.percentile(it, 99)),
                "incr_gap_m_max": float(it.max()),
                "incr_rot_rad_p50": float(np.percentile(ir, 50)),
                "incr_rot_rad_p99": float(np.percentile(ir, 99)),
                "map_mismatch": max(self.maps, default=0.0),
                **({"rounds_differ_share": float(self.rounds[1] / self.rounds[0]),
                    "incr_gap_share_rounds_differ":
                        float(self.rounds[2] / max(self.rounds[3], 1e-30))}
                   if self.rounds[0] else {}),
                "scans_compared": int(pos.size if self.pos else 0)}


def compare_passes(passes: list, refs) -> dict:
    """passes: [{"drive": d, "poses": [(7,) per answered scan], "map": keys
    (a complete pass, optional), "rounds": ICP rounds per scan (optional)}];
    refs[d]: the reference's {"poses", "map", "stats"}."""
    gaps, by_drive = Gaps(), {}
    for p in passes:
        ref = refs[p["drive"]]
        prog = np.asarray(p["poses"], np.float64).reshape(-1, 7)
        maps = (p["map"], ref["map"]) if p.get("map") is not None else None
        rounds = None
        if p.get("rounds") is not None:
            rounds = (p["rounds"], [st.rounds if st is not None else 0 for st in ref["stats"]])
        gaps.add(prog, ref["poses"][: len(prog)], maps, rounds)
        if len(prog):
            by_drive[p["drive"]] = max(by_drive.get(p["drive"], 0.0), float(gaps.pos[-1].max()))
    out = gaps.numbers()
    out["pose_gap_m_by_drive"] = [by_drive[d] for d in sorted(by_drive)]
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """Some answers compared, and every number named in the limits within
    its limit."""
    return all(numbers[k] <= v for k, v in limits.items()) and numbers["scans_compared"] > 0
