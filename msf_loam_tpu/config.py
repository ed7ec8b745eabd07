"""Configuration system for the MSF-LOAM engine.

Surfaces every tunable that the reference hard-codes (see SURVEY.md §2) plus
the reference's own three config layers (gflags / proto-JSON `MsfLoamConfig`
at ``/root/reference/proto/config.proto:7-20`` / ROS params at
``msf_loam_node.cc:434``, ``laser_mapping.cc:58-68``). Dataclasses are
hashable+frozen so they can be passed as static args to ``jax.jit``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Scan registration / feature extraction (reference msf_loam_node.cc)."""

    max_scan_lines: int = 128          # kMaxScanNum (msf_loam_node.cc:79)
    scan_period: float = 0.1           # kScanPeriod (msf_loam_node.cc:80)
    min_range: float = 0.3             # ROS param minimum_range (msf_loam_node.cc:434)
    num_sectors: int = 6               # sectors per ring (msf_loam_node.cc:255)
    sharp_per_sector: int = 2          # (msf_loam_node.cc:277)
    less_sharp_per_sector: int = 20    # (msf_loam_node.cc:281)
    flat_per_sector: int = 4           # (msf_loam_node.cc:317)
    curvature_threshold: float = 0.1   # sharp >0.1 / flat <0.1 (msf_loam_node.cc:275,312)
    neighbor_suppress: int = 5         # +/-5 neighbors (msf_loam_node.cc:290-303)
    neighbor_gap_sq: float = 0.05      # suppression break gap^2 (msf_loam_node.cc:293)
    edge_margin: int = 5               # skip first/last 5 pts per ring (msf_loam_node.cc:192-194)
    less_flat_leaf: float = 0.2        # VoxelGrid leaf (msf_loam_node.cc:121)
    # filter less-flat per scan line like the reference (one VoxelGrid per
    # ring concatenated, msf_loam_node.cc:347-348) instead of globally;
    # denser cloud, A/B-measured ATE-equivalent (docs/RESULTS.md)
    less_flat_per_ring: bool = False
    # occluded-boundary / parallel-beam pick rejection (LOAM RSS'14 §5.1;
    # absent from the A-LOAM-derived reference — without it, street-scene
    # occlusion veils bias the mapping solve along the travel direction)
    occlusion_gap: float = 0.3         # adjacent-range jump marking a veil (m)
    parallel_frac: float = 0.02        # both-neighbor range diff vs range
    # corner picks must also beat corner_gate_factor x the sector's
    # smooth-population mean curvature (noise floor): sectors that see only
    # smooth ground pick no "edges" from range noise
    corner_gate_factor: float = 10.0
    # --- static-shape budgets for the device arrays ---
    max_points_per_ring: int = 2048    # ring buffer width (VLP-16 ~1800/rev @10Hz)
    max_less_flat: int = 8192          # cap on downsampled less-flat points


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    """Scan-to-scan matching (reference odometry_scan_matcher.cc)."""

    dist_sq_threshold: float = 25.0    # kDistanceSqThreshold (odometry_scan_matcher.cc:16)
    nearby_scan: float = 2.5           # kNearByScan ring window (odometry_scan_matcher.cc:17)
    outer_rounds: int = 2              # kOptimalNum (odometry_scan_matcher.cc:18)
    gn_iterations: int = 6             # ceres max_num_iterations (odometry_scan_matcher.cc:271)
    huber_delta: float = 0.1           # HuberLoss(0.1) (odometry_scan_matcher.cc:67)
    min_correspondences: int = 10      # (odometry_scan_matcher.cc:262)
    # plane correspondence construction: "fit" = 5-point structured support
    # (a + 2 same-ring + 2 different-ring) with a TLS plane + planarity
    # gate — measurably removes the systematic body-frame pull the 3-point
    # triangle's noise-dominated normals inject (scripts/diag_odometry.py);
    # "triangle" = the reference's exact a/b/c construction
    # (odometry_scan_matcher.cc:172-232).
    plane_corr: str = "fit"
    plane_fit_tol: float = 0.2         # planarity bound for plane_corr="fit"
    plane_support_extra: int = 4       # extra nearest-any-ring support points
    # reject correspondences whose point-to-line/plane residual at the live
    # estimate exceeds this (meters; 0 disables). The enabled form of the
    # reference's commented-out RefineByRejectOutliersWithThreshold
    # (scan_matcher.cc:13-38) — kills newly-revealed-surface mismatches
    # whose signed pull Huber only caps.
    corr_max_resid: float = 0.75
    # gate relaxation factor for all but the final re-association round
    # (the warm start can be decimeters off at turn onset)
    corr_gate_relax: float = 2.0
    # reproject mapping/insert inputs to scan start with the constant-
    # velocity motion prior (classic LOAM TransformToStart; the reference
    # ships with its DISTORTION flag off and leaves lidar-only scans
    # distorted). Applies to the pure-lidar path and, translation-only, to
    # the pre-init LIO window — post-init the IMU deskew is exact and this
    # is unused. Default OFF for reference parity and because the synthetic
    # accuracy suite feeds undistorted scans (where the correction would
    # INJECT distortion); enable for real spinning-lidar data or
    # --distorted sims.
    motion_deskew: bool = False
    # in-loop deskew inside the scan-to-scan matcher (the A-LOAM
    # DISTORTION=1 TransformToStart, which the reference disables): per
    # re-association round the CURRENT scan reprojects with the live pose
    # estimate and the reference scan with the warm-start step, so the
    # estimated step is scan-start-to-scan-start and the estimator error
    # contracts across rounds (Picard). NOT the stale-prior chain (deskew
    # once with the previous step, match rigidly) — that diverges without
    # a map anchor (measured 13 -> 112 %/100m). Needs rel_time/scan_period
    # consistent with FeatureConfig.scan_period.
    deskew: bool = False
    scan_period: float = 0.1           # must equal FeatureConfig.scan_period


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """Scan-to-map matching + map maintenance (laser_mapping.cc,
    mapping_scan_matcher.cc, hybrid_grid.cc)."""

    line_resolution: float = 0.2       # mapping_line_resolution (laser_mapping.cc:60)
    plane_resolution: float = 0.4      # mapping_plane_resolution (laser_mapping.cc:62)
    knn: int = 5                       # 5-NN (mapping_scan_matcher.cc:125,195)
    knn_dist_sq_max: float = 1.0       # gate dist^2[4] < 1.0 (mapping_scan_matcher.cc:128,198)
    # wide-neighborhood plane fallback: where the strict 5-NN surf
    # neighborhood is a degenerate ring arc (anisotropic scan density —
    # floor/ceiling grazed along the ring), refit on up to knn_wide
    # candidates from the same 8-cell gather at up to cell_size radius.
    # Restores out-of-plane (z) observability the reference silently lacks
    # (its 5-NN + residual check accepts collinear fits with garbage
    # normals, mapping_scan_matcher.cc:198-220).
    plane_fallback: bool = True
    knn_wide: int = 16
    # gather the 8-cell candidate sets once per frame and re-run only the
    # distance/top-k selection each re-association round (the gather is
    # the costly half; see voxel_map.gather_candidates). Exactness bound:
    # inter-round pose updates must stay well under map_cell_size/2.
    reuse_candidates: bool = True
    line_eig_ratio: float = 3.0        # λ2 > 3 λ1 line test (mapping_scan_matcher.cc:147)
    plane_fit_tol: float = 0.2         # planarity residual bound (mapping_scan_matcher.cc:216)
    outer_rounds: int = 2              # kOptimalNum (mapping_scan_matcher.cc:15)
    gn_iterations: int = 6             # (mapping_scan_matcher.cc:48)
    huber_delta: float = 0.1           # (mapping_scan_matcher.cc:77)
    min_map_corner: int = 10           # skip-if-small gates (laser_mapping.cc:284)
    min_map_surf: int = 50             # (laser_mapping.cc:285)
    query_radius: float = 60.0         # kDist surround horizon (hybrid_grid.cc:532)
    # --- hash-grid map parameters (replaces Cartographer HybridGrid) ---
    map_cell_size: float = 2.0         # spatial-hash cell edge (reference uses 3.0 m clouds)
    map_table_size: int = 1 << 15      # hash table slots per feature map
    map_cell_capacity: int = 32        # point slab per cell
    max_query_points: int = 4096       # static query batch per feature type
    # Separate (smaller) budget for corner queries: corner clouds are far
    # sparser than surf (measured ~540 valid of a 1920 budget on the bench
    # world), and every padded row still pays the full octant gather +
    # selection/fit. 0 = use max_query_points.
    max_corner_query_points: int = 0
    map_evict_radius: float = 100.0    # release cells beyond this (60 m query
                                       # horizon analog, hybrid_grid.cc:532)
    map_evict_period: int = 10         # frames between eviction passes

    @property
    def corner_query_points(self) -> int:
        """Effective corner query budget (max_corner_query_points, falling
        back to the shared max_query_points when unset)."""
        return self.max_corner_query_points or self.max_query_points


@dataclasses.dataclass(frozen=True)
class ImuConfig:
    """IMU noise + preintegration (parameters.h, laser_mapping.cc:36-38,
    proto config `imu_intrinsic_parameters`)."""

    acc_n: float = 0.017
    acc_w: float = 0.007
    gyr_n: float = 0.0033
    gyr_w: float = 0.0012
    update_rate: float = 400.0
    # preintegration lowering: "assoc" = log-depth associative scans
    # (6 sequential levels for a 40-sample window instead of 40 steps);
    # "scan" = the literal per-sample lax.scan (reference-shaped)
    preint_mode: str = "assoc"
    gravity: Tuple[float, float, float] = (0.0, 0.0, 9.81)
    warmup_msgs: int = 100             # lidar gate until >100 imu msgs (msf_loam_node.cc:384)
    init_frames: int = 50              # kInitByFirstScanNums (estimator.h:57)
    init_reject_frac: float = 0.15     # reject worst 15% (estimator.cc:102)
    max_lidar_imu_offset: float = 0.01 # error gate (estimator.cc:125)
    sqrt_info_scale: float = 0.001     # imu_factor.cc:43
    max_imu_samples: int = 64          # static preintegration window length
    # weight of the IMU factor inside the tight lidar GN; measured sweep
    # (distorted 9-frame corridor): w=1 lets thousands of lidar rows pull
    # the freed velocity off-truth (ATE 0.044), w=10 balances (ATE 0.035,
    # velocity within 0.13 m/s); w=100 no further gain
    imu_factor_weight: float = 10.0
    # tightly-coupled mode: put the IMU factor IN the lidar GN and free the
    # velocity state (the reference holds v constant and notes the drift
    # consequence, mapping_scan_matcher.cc:93). Measured: ATE 0.069 (held
    # constant) -> 0.035 (freed, w=10) on the distorted-scan A/B
    # (tests/test_lio_pipeline.py::test_lio_tight_coupling_tracks).
    tight_coupling: bool = False
    # re-run the gravity/velocity init solve over the freshest init_frames
    # mapped states every N frames (0 = frozen-after-init like the
    # reference, estimator.cc). Init-era gravity inherits the warm-up
    # frames' rotation-only-deskew pose errors; a ~1.4 deg tilt injects
    # ~0.24 m/s^2 phantom acceleration into every velocity prediction.
    grav_refine_period: int = 10
    # --- online bias estimation (imu/bias_estimator.py) ---
    # The reference pins both biases to zero (SubsetParameterization,
    # mapping_scan_matcher.cc:46) while carrying the full bias machinery;
    # here a windowed GN over mapped-pose-anchored IMU factors estimates a
    # shared (ba, bg) every bias_period frames post-init. 0 disables.
    bias_period: int = 10
    bias_window: int = 10              # pairs per solve (W+1 states)
    bias_prior_acc_sigma: float = 0.1  # zero-mean prior sigmas (m/s^2,
    bias_prior_gyr_sigma: float = 0.05 #  rad/s; whitened via sqrt_info_scale)
    bias_vel_prior_sigma: float = 0.5  # velocity tie to lidar-tracked seeds
    bias_max_acc: float = 0.5          # sanity clamps (m/s^2, rad/s)
    bias_max_gyr: float = 0.05
    # EMA across solves: each window's estimate carries mapped-pose-delta
    # noise (~1.5e-3 rad/s floor measured on the corridor test world);
    # averaging successive windows converges toward the true bias
    bias_ema: float = 0.5


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    """GPS fusion pose graph (gps_fusion.cc)."""

    gps_sigma_t: float = 0.01          # GpsFactor st (gps_fusion.cc:67)
    rel_sigma_r: float = 0.01          # RelativePoseFactor sr (gps_fusion.cc:77)
    rel_sigma_t: float = 0.1           # RelativePoseFactor st (gps_fusion.cc:77)
    huber_delta: float = 1.0           # HuberLoss(1.0) (gps_fusion.cc:48)
    iterations: int = 10               # max_num_iterations (gps_fusion.cc:45)
    sim_gps_period: int = 10           # every 10th gt odom -> 1 Hz (laser_mapping.cc:456)
    sim_gps_noise: float = 0.05        # U(-5,5) cm (laser_mapping.cc:458)
    # loop closure (beyond the reference's sparse_pose_graph stub)
    loop_max_dist: float = 3.0         # proximity radius for candidates (m)
    loop_min_index_gap: int = 20       # frames between revisit candidates
    loop_max_count: int = 8            # static padding for LoopFactors
    loop_keyframe_stride: int = 5      # keep features every K frames
    loop_sc_max_dist: float = 0.25     # scan-context cosine-distance gate


@dataclasses.dataclass(frozen=True)
class ExtrinsicConfig:
    """lidar2imu extrinsic + hand-eye calibration (initial_ex_rotation.cc)."""

    lidar2imu_t: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    lidar2imu_q: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)  # wxyz
    calib_window: int = 10             # kWindowSize (initial_ex_rotation.cc:10)
    calib_sigma_gate: float = 0.25     # σ1 > 0.25 accept (initial_ex_rotation.cc:63)
    calib_huber_deg: float = 5.0       # Huber weight knee (initial_ex_rotation.cc:37)


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Host pipeline / execution knobs."""

    offline_mode: bool = True          # -is_offline_mode analog
    drop_backlog: bool = False         # real-time load shedding (laser_mapping.cc:159-165)
    save_map: bool = True              # save_pointcloud_map proto field
    map_output: str = "msf_loam_cloud.ply"
    trajectory_output: str = "trajectory.npz"  # pbstream analog
    dtype: str = "float32"
    profile: bool = False


@dataclasses.dataclass(frozen=True)
class MsfLoamConfig:
    """Top-level config (proto MsfLoamConfig analog, fully surfaced)."""

    features: FeatureConfig = dataclasses.field(default_factory=FeatureConfig)
    odometry: OdometryConfig = dataclasses.field(default_factory=OdometryConfig)
    mapping: MappingConfig = dataclasses.field(default_factory=MappingConfig)
    imu: ImuConfig = dataclasses.field(default_factory=ImuConfig)
    posegraph: PoseGraphConfig = dataclasses.field(default_factory=PoseGraphConfig)
    extrinsic: ExtrinsicConfig = dataclasses.field(default_factory=ExtrinsicConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        """Reject configs that would silently produce wrong answers.

        The 8-cell octant query (voxel_map.query_knn) is only COMPLETE out
        to radius map_cell_size/2; a knn distance gate beyond that radius
        would accept incomplete neighbor sets without any error signal, so
        it is a hard config-time error, not a comment.
        """
        mc = self.mapping
        r_complete_sq = (mc.map_cell_size / 2.0) ** 2
        if mc.knn_dist_sq_max > r_complete_sq + 1e-9:
            raise ValueError(
                f"mapping.knn_dist_sq_max={mc.knn_dist_sq_max} exceeds the "
                f"8-cell query completeness bound (map_cell_size/2)^2="
                f"{r_complete_sq}: queries would silently return incomplete "
                f"neighbor sets. Raise map_cell_size or lower the gate.")
        if mc.map_table_size <= 0 or mc.map_cell_capacity <= 0:
            raise ValueError("mapping.map_table_size and map_cell_capacity "
                             "must be positive")
        if mc.max_query_points < mc.knn:
            raise ValueError(
                f"mapping.max_query_points={mc.max_query_points} is below "
                f"knn={mc.knn}; the static query budget cannot hold one "
                f"correspondence set")
        if mc.max_corner_query_points < 0 or \
                0 < mc.max_corner_query_points < mc.knn:
            raise ValueError(
                f"mapping.max_corner_query_points="
                f"{mc.max_corner_query_points} must be 0 (share "
                f"max_query_points) or >= knn={mc.knn}")
        if mc.knn < 2:
            raise ValueError("mapping.knn must be >= 2 (line/plane fits "
                             "need multiple neighbors)")
        fc = self.features
        if fc.sharp_per_sector > fc.less_sharp_per_sector:
            raise ValueError("features.sharp_per_sector cannot exceed "
                             "less_sharp_per_sector (sharp picks are a "
                             "prefix of the less-sharp set)")
        if self.odometry.deskew and \
                abs(self.odometry.scan_period - fc.scan_period) > 1e-9:
            raise ValueError(
                f"odometry.scan_period={self.odometry.scan_period} != "
                f"features.scan_period={fc.scan_period}: the in-matcher "
                f"deskew would mis-scale every point's rel_time fraction")

    @staticmethod
    def from_json(path: str) -> "MsfLoamConfig":
        """Load a config from JSON. Accepts both this framework's nested
        layout and the reference's proto-JSON schema
        (e.g. ``/root/reference/config/lio-sam-config2.json``)."""
        with open(path) as f:
            raw = json.load(f)
        return MsfLoamConfig.from_dict(raw)

    @staticmethod
    def from_dict(raw: dict) -> "MsfLoamConfig":
        cfg = MsfLoamConfig()
        # Reference proto-JSON schema compatibility.
        if "imuIntrinsicParameters" in raw or "imu_intrinsic_parameters" in raw:
            imu_raw = raw.get("imuIntrinsicParameters", raw.get("imu_intrinsic_parameters", {}))
            g_raw = raw.get("gravityVector", raw.get("gravity_vector", {}))
            ext_raw = raw.get(
                "lidar2imuExtrinsicParameters", raw.get("lidar2imu_extrinsic_parameters", {})
            )
            imu = dataclasses.replace(
                cfg.imu,
                acc_n=float(imu_raw.get("accelerometerNoiseDensity",
                                        imu_raw.get("accelerometer_noise_density", cfg.imu.acc_n))),
                acc_w=float(imu_raw.get("accelerometerRandomWalk",
                                        imu_raw.get("accelerometer_random_walk", cfg.imu.acc_w))),
                gyr_n=float(imu_raw.get("gyroscopeNoiseDensity",
                                        imu_raw.get("gyroscope_noise_density", cfg.imu.gyr_n))),
                gyr_w=float(imu_raw.get("gyroscopeRandomWalk",
                                        imu_raw.get("gyroscope_random_walk", cfg.imu.gyr_w))),
                update_rate=float(imu_raw.get("updateRate",
                                              imu_raw.get("update_rate", cfg.imu.update_rate))),
                gravity=(
                    float(g_raw.get("x", 0.0)),
                    float(g_raw.get("y", 0.0)),
                    float(g_raw.get("z", 9.81)),
                ),
            )
            t_raw = ext_raw.get("translation", {})
            q_raw = ext_raw.get("rotation", {})
            ext = dataclasses.replace(
                cfg.extrinsic,
                lidar2imu_t=(float(t_raw.get("x", 0.0)), float(t_raw.get("y", 0.0)),
                             float(t_raw.get("z", 0.0))),
                lidar2imu_q=(float(q_raw.get("w", 1.0)), float(q_raw.get("x", 0.0)),
                             float(q_raw.get("y", 0.0)), float(q_raw.get("z", 0.0))),
            )
            runtime = dataclasses.replace(
                cfg.runtime,
                save_map=bool(raw.get("savePointcloudMap",
                                      raw.get("save_pointcloud_map", cfg.runtime.save_map))),
            )
            return dataclasses.replace(cfg, imu=imu, extrinsic=ext, runtime=runtime)

        # Native nested layout: {"features": {...}, "odometry": {...}, ...}
        sections = {}
        for field in dataclasses.fields(MsfLoamConfig):
            if field.name in raw:
                sub_cls = field.default_factory  # type: ignore[misc]
                sub_raw = dict(raw[field.name])
                for k, v in sub_raw.items():
                    if isinstance(v, list):
                        sub_raw[k] = tuple(v)
                sections[field.name] = dataclasses.replace(sub_cls(), **sub_raw)
        return dataclasses.replace(cfg, **sections)
