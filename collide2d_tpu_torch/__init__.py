"""collide2d_tpu_torch — the 2D convex collision engine on PyTorch and CUDA.

A port of ``collide2d_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
This package covers the rectangle and convex k-gon models on one GPU: the
annulus configuration sampler, the adaptive Monte Carlo driver with its
Wald / rule-of-three stopping rule and noise-aware pruning, the fused
Monte Carlo kernels (``csrc/mc_kernel.cu``, ``csrc/mc_polygon_kernel.cu``),
the SAT and oriented-box label and count kernels (``csrc/sat_kernel.cu``),
the k-gon SAT kernel (``csrc/polygon_kernel.cu``), trajectory labels
(`MovingConfigs`, `MovingPolygonConfigs`, with the fused trajectory kernels
``csrc/mc_toi_kernel.cu``, ``csrc/mc_moving_polygon_kernel.cu`` and the
rotating cascade's screen ``csrc/screen_kernel.cu``), the geometry queries
(signed distance, witness points, contact manifolds, time of impact) with
their kernels (``csrc/distance_kernel.cu``, ``csrc/manifold_kernel.cu``,
``csrc/toi_kernel.cu``; all built with nvcc at first use), ray casting
and the scene queries (`scene_raycast` on ``csrc/raycast_kernel.cu``; the
N-body collision matrix, pair lists and contact manifolds on the k-gon SAT
and manifold kernels), `convex_hull`,
`CollisionProbabilityModel`, `PolygonCollisionProbabilityModel`, the
learned surrogate (`featurize`, `TrainConfig`, `train_model`,
`LearnedCollisionModel`; its signed-distance feature on kernel 8), the
``generate`` / ``relabel`` / ``ztest`` / ``compare`` / ``polylabel`` /
``movelabel`` / ``bench`` / ``balance`` / ``show`` / ``train`` /
``predict`` commands (``collide2d-torch``) and the bench
headline (``python -m collide2d_tpu_torch.bench``, with the
streaming-bandwidth probe ``csrc/stream_kernel.cu``).

It imports torch and never jax. Nothing is built or launched at import.
"""

from collide2d_tpu_torch.mc.estimator import (
    AdaptiveConfig,
    Configs,
    PolygonConfigs,
    collision_probability,
    collision_probability_pruned,
    configs_from_numpy,
    mc_round,
    polygon_configs_from_numpy,
)
from collide2d_tpu_torch.mc.driver import adaptive_collision_probabilities
from collide2d_tpu_torch.mc.schedule_sim import (
    min_convergence_points,
    optimize_checkpoints,
    simulate_convergence,
    simulate_schedule,
)
from collide2d_tpu_torch.mc.stats import calc_slack, get_bin
from collide2d_tpu_torch.mc.moving import (
    MovingConfigs,
    MovingPolygonConfigs,
    moving_configs,
    moving_polygon_configs,
    trajectory_collision_probability,
)
from collide2d_tpu_torch.models.collision_model import (
    CollisionProbabilityModel,
    PolygonCollisionProbabilityModel,
    example_configs,
    example_polygon_configs,
)
from collide2d_tpu_torch.models.learned import (
    LearnedCollisionModel,
    TrainConfig,
    featurize,
    train_model,
)
from collide2d_tpu_torch.ops.broad_phase import (
    aabb_overlap,
    candidate_mask,
    collide_candidates,
    collide_polygons_pruned,
    possible_collision_mask,
)
from collide2d_tpu_torch.ops.distance import (
    polygon_closest_points,
    polygon_signed_distance,
    rect_closest_points,
    rect_signed_distance,
)
from collide2d_tpu_torch.ops.geometry import (
    convex_hull,
    polygon_aabb,
    rect_vertices,
    rects_from_params,
    transform_vertices,
)
from collide2d_tpu_torch.ops.manifold import (
    polygon_contact_manifold,
    rect_contact_manifold,
)
from collide2d_tpu_torch.ops.raycast import (
    polygon_raycast,
    rect_raycast,
    scene_raycast,
)
from collide2d_tpu_torch.ops.sat import (
    obb_collide,
    sat_polygons,
    sat_rects,
    sat_rects_reference,
)
from collide2d_tpu_torch.ops.toi import (
    polygon_time_of_impact,
    polygon_translation_toi_parts,
    rect_time_of_impact,
    rect_translation_toi,
)
from collide2d_tpu_torch.ops.scene import (
    scene_colliding_pairs,
    scene_colliding_pairs_swept,
    scene_collision_matrix,
    scene_contact_manifolds,
)

__all__ = [
    "AdaptiveConfig",
    "CollisionProbabilityModel",
    "Configs",
    "LearnedCollisionModel",
    "MovingConfigs",
    "MovingPolygonConfigs",
    "PolygonCollisionProbabilityModel",
    "PolygonConfigs",
    "TrainConfig",
    "aabb_overlap",
    "adaptive_collision_probabilities",
    "calc_slack",
    "candidate_mask",
    "collide_candidates",
    "collide_polygons_pruned",
    "collision_probability",
    "collision_probability_pruned",
    "configs_from_numpy",
    "convex_hull",
    "example_configs",
    "example_polygon_configs",
    "featurize",
    "get_bin",
    "mc_round",
    "min_convergence_points",
    "moving_configs",
    "moving_polygon_configs",
    "obb_collide",
    "optimize_checkpoints",
    "polygon_aabb",
    "polygon_closest_points",
    "polygon_configs_from_numpy",
    "polygon_contact_manifold",
    "polygon_raycast",
    "polygon_signed_distance",
    "polygon_time_of_impact",
    "polygon_translation_toi_parts",
    "possible_collision_mask",
    "rect_closest_points",
    "rect_contact_manifold",
    "rect_raycast",
    "rect_signed_distance",
    "rect_time_of_impact",
    "rect_translation_toi",
    "rect_vertices",
    "rects_from_params",
    "sat_polygons",
    "sat_rects",
    "sat_rects_reference",
    "scene_colliding_pairs",
    "scene_colliding_pairs_swept",
    "scene_collision_matrix",
    "scene_contact_manifolds",
    "scene_raycast",
    "simulate_convergence",
    "simulate_schedule",
    "train_model",
    "trajectory_collision_probability",
    "transform_vertices",
]
