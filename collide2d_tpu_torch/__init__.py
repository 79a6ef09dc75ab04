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
``csrc/toi_kernel.cu``; all built with nvcc at first use),
`CollisionProbabilityModel`, `PolygonCollisionProbabilityModel`, and the
``generate`` / ``relabel`` / ``ztest`` / ``compare`` / ``polylabel`` /
``movelabel`` commands (``collide2d-torch``).

It imports torch and never jax. Nothing is built or launched at import.
"""

from collide2d_tpu_torch.mc.estimator import (
    AdaptiveConfig,
    Configs,
    PolygonConfigs,
    collision_probability,
    configs_from_numpy,
    polygon_configs_from_numpy,
)
from collide2d_tpu_torch.mc.driver import adaptive_collision_probabilities
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
from collide2d_tpu_torch.ops.distance import (
    polygon_closest_points,
    polygon_signed_distance,
    rect_closest_points,
    rect_signed_distance,
)
from collide2d_tpu_torch.ops.manifold import (
    polygon_contact_manifold,
    rect_contact_manifold,
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

__all__ = [
    "AdaptiveConfig",
    "CollisionProbabilityModel",
    "Configs",
    "MovingConfigs",
    "MovingPolygonConfigs",
    "PolygonCollisionProbabilityModel",
    "PolygonConfigs",
    "adaptive_collision_probabilities",
    "collision_probability",
    "configs_from_numpy",
    "example_configs",
    "example_polygon_configs",
    "moving_configs",
    "moving_polygon_configs",
    "obb_collide",
    "polygon_closest_points",
    "polygon_configs_from_numpy",
    "polygon_contact_manifold",
    "polygon_signed_distance",
    "polygon_time_of_impact",
    "polygon_translation_toi_parts",
    "rect_closest_points",
    "rect_contact_manifold",
    "rect_signed_distance",
    "rect_time_of_impact",
    "rect_translation_toi",
    "sat_polygons",
    "sat_rects",
    "sat_rects_reference",
    "trajectory_collision_probability",
]
