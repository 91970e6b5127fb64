"""Odometry configuration (a copy of the JAX package's ``config.py``).

The field names and defaults are the JAX package's, so a config dict moves
across the two frameworks unchanged. Two fields are kept only for that:
``icp_use_pallas`` and ``icp_use_pallas_jtwj`` select TPU kernels there and
are ignored here, where the CUDA kernels always run on CUDA tensors.

Exposes the reference's 8 ROS parameters (reference
src/lidar_odometry.h:36-48) *plus* the constants the reference hard-codes in
its matcher/classifier (src/cloud_matcher.cpp:111-139,153,169 and
src/utils/cloud_classifier.h:83-112) since they define the accuracy envelope,
*plus* the static-shape capacities that a TPU build needs (padded point
budgets, voxel-table capacity) which have no reference analogue because PCL
clouds and robin_map grow dynamically.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    # --- reference ROS parameters (src/lidar_odometry.h:36-48 defaults) ---
    lidar_min_range: float = 4.0
    lidar_max_range: float = 80.0
    keyframe_voxel_size: float = 0.2
    keyframe_max_points_cnt: int = 20
    keyframe_matching_voxel_size: float = 0.3
    keyframe_update_voxel_size: float = 0.1
    keyframe_cleanup_range: float = 80.0
    angular_divergence_threshold: float = 5.0  # degrees

    # Deskew translation interpolation direction. The reference interpolates
    # translation *backwards* in time (start.t * t + end.t * (1-t),
    # src/utils/cloud_transform.h:29-30) while rotation slerps forward — a
    # verified bug: against simulated ground truth at 5 m/s the reference
    # formula leaves ~0.27 m mean intra-scan error (barely better than no
    # deskew) where the forward formula leaves < 1 mm
    # (scripts/deskew_quirk_check.py). Default True = corrected (forward)
    # interpolation; set False for bit-parity with reference semantics.
    deskew_forward_translation: bool = True

    # --- reference hard-coded matcher constants (src/cloud_matcher.cpp) ---
    icp_max_correspondence_distance: float = 0.3  # :139
    icp_huber_delta: float = 0.15                 # :134 HuberLoss(0.15)
    icp_translation_prior_sigma: float = 0.1      # :153 NormalPrior diag(0.1)^-1
    icp_max_outer_iterations: int = 35            # :117
    icp_inner_iterations: int = 4                 # :111 max_num_iterations
    icp_convergence_step_norm: float = 1e-4       # :169 step_norm threshold
    icp_min_outer_iterations: int = 4             # :169 "&& (i>3)"
    icp_damping: float = 1e-6  # relative LM damping on the 6x6 (Ceres trust region analogue)
    # Stall exit (beyond-reference): ICP can limit-cycle between
    # correspondence sets; the reference burns all 35 outer rounds and keeps
    # round 35's pose. We track the best robust mean cost seen and exit
    # after this many consecutive non-improving rounds. Set to 35 to disable
    # the early exit (the full reference iteration budget is then spent).
    icp_stall_exit_rounds: int = 3
    icp_stall_rel_tolerance: float = 1e-4  # relative cost-improvement bar
    # On a non-converged exit (stall or 35-round cap), return the best-cost
    # pose seen instead of the last round's pose (strictly no worse). The
    # reference always returns the final round's pose
    # (cloud_matcher.cpp:175-177); set False for exact parity at the cap.
    icp_best_pose_exit: bool = True
    # Gather each query's 27-voxel candidates once per scan (at the guess
    # pose) and re-match against the cache every outer iteration, instead
    # of re-gathering from the table per iteration. Random-access gathers
    # run ~20x below stream bandwidth on TPU; the cache turns the per-
    # iteration search into linear VPU math (see vm.CandidateSet). Set
    # False for the literal re-search-every-iteration reference semantics.
    icp_cached_candidates: bool = True
    # TPU kernel switches of the JAX package; ignored by this port (its
    # CUDA kernels are not optional on the card). Kept so that config
    # dicts move across unchanged.
    icp_use_pallas: bool = False
    icp_use_pallas_jtwj: bool = False

    # --- reference hard-coded classifier constants (src/utils/cloud_classifier.h) ---
    curvature_window: int = 4          # :83
    curvature_invalid_value: float = 1000.0  # :84 intensity_max
    min_valid_range_sq: float = 0.1    # :88 range^2 < 0.1 -> invalid
    normals_window: int = 4            # :109
    flatness_threshold: float = 0.05   # :112
    neighbor_flatness_factor: float = 10.0  # :125 threshold*10 for neighbours

    # --- static-shape capacities (TPU-native; no reference analogue) ---
    num_rings: int = 16            # VLP16 (reference README.md:12, lidar_point_type.h)
    scan_width: int = 1800         # azimuth bins; VLP16 @10Hz ~0.2deg -> 1800
    max_raw_points: int = 32768    # padded raw scan capacity (16*1800=28800 fits)
    max_planar_points: int = 16384  # planar-feature budget after classification
    max_match_points: int = 8192   # matching-downsample budget (0.3 m grid)
    max_update_points: int = 16384  # keyframe-update budget (0.1 m grid)
    # voxel-table slots (2^17). When live voxels exceed capacity the
    # table keeps the C smallest KEYS (lexicographic (x,y,z) order — a
    # documented deviation; the reference's robin_map grows unboundedly).
    # The default SATURATES on dense long drives (the bench simulator's
    # 300-scan drive fills it by scan ~82 with ATE still 0.015 m — the
    # 80 m radius eviction keeps the working set near the sensor, so the
    # drop hits the fringe); saturation is observable as
    # map_voxels == map_capacity in StepDiagnostics and as
    # "map_saturated" in CLI JSON lines. Raise for fringe-complete maps
    # at proportional per-scan cost (every table pass is C-bound).
    map_capacity: int = 131072
    # voxel-key packing: 11/11/9 bits (x/y/z) around a rebasable integer
    # origin; rebase when the sensor drifts this far from the map origin.
    map_rebase_distance: float = 50.0

    # numerical dtype for point geometry. bf16 is too coarse for cm-level
    # registration; f32 everywhere, tiny 6x6 solve also f32 (delta-pose
    # parameterization keeps it well-conditioned; Ceres uses f64 but solves
    # absolute quaternions).
    dtype: str = "float32"

    def replace(self, **kw: Any) -> "OdometryConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "OdometryConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**dict(d))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def reference_parity(base: OdometryConfig | None = None) -> OdometryConfig:
    """Config preset with every beyond-reference default flipped back to
    strict reference semantics (src/cloud_matcher.cpp, cloud_transform.h):

    - deskew translation interpolated backwards in time
      (cloud_transform.h:29-30 quirk),
    - correspondences re-searched from the table every outer iteration
      (findMatchingPairs per round, cloud_matcher.cpp:138-139),
    - the full 35-round outer budget with no stall exit and the final
      round's pose returned on cap exit (cloud_matcher.cpp:117,175-177).

    Parity tests and benchmarks should use this preset instead of flipping
    individual knobs (which drift as knobs are added).
    """
    base = base or OdometryConfig()
    return base.replace(
        deskew_forward_translation=False,
        icp_cached_candidates=False,
        icp_stall_exit_rounds=base.icp_max_outer_iterations,
        icp_best_pose_exit=False,
    )


REFERENCE_PARITY = reference_parity()


# Small shapes for unit tests / dry runs: keeps compile times low.
TINY = OdometryConfig(
    scan_width=128,
    max_raw_points=2048,
    max_planar_points=1024,
    max_match_points=512,
    max_update_points=1024,
    map_capacity=4096,
)
