"""The check's control: the plain reference put in the program's place and
computed in the precision below the configuration's (float32 matrix
products in TF32, where the configuration states float32 with TF32 off),
held to the reference by the same comparison as a run. Where it reads as
correct, the check could not tell a program computing in TF32 from a sound
one.

    python3 odobench/control.py --workload <cell> --seeds 1 2 3

For each seed: the cell's drives made as a run makes them (every drive of
a replay, every lane of a fleet), the reference once with TF32 off and once
with it on, and one line of JSON per seed with every number of the
comparison. Needs a CUDA device (TF32 exists only there).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import checks  # noqa: E402
import harness  # noqa: E402
from reference import odometry as ref_odometry  # noqa: E402


def drives_for(cell, seed: int, device) -> list:
    """The cell's inputs as lists of raw scans (xyz, time, ring, valid):
    every drive of the run, every lane of a fleet."""
    return [[(d.xyz[s], d.time[s], d.ring[s], d.valid[s]) for s in range(d.xyz.shape[0])]
            for d in harness.drives_of(cell, seed, device)]


def run(rcfg, scans, device, tf32: bool):
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        odo = ref_odometry.Odometry(rcfg, device)
        poses = [np.concatenate([r.t, r.q]).astype(np.float64)
                 for r in (odo.step(*sc) for sc in scans)]
        return np.stack(poses), odo.map.keys.cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def readings(cell, seed: int, device) -> dict:
    """The control's numbers for one seed: every drive of the cell's run
    through the reference with TF32 off and on, compared by the run's own
    comparison."""
    rcfg = harness.ref_config(cell)
    gaps = checks.Gaps()
    for scans in drives_for(cell, seed, device):
        ref_p, ref_m = run(rcfg, scans, device, tf32=False)
        ctl_p, ctl_m = run(rcfg, scans, device, tf32=True)
        gaps.add(ctl_p, ref_p, (ctl_m, ref_m))
    out = gaps.numbers()
    out["correct"] = checks.verdict(out, cell.limits)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control needs a CUDA device (TF32)", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        out = readings(cell, seed, device)
        out.update(workload=args.workload, seed=seed, card=torch.cuda.get_device_name(0))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
