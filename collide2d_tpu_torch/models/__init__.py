"""The user-facing models built on the ops/mc layers: `collision_model`
(labels, probabilities and geometry queries) and `learned` (the learned
collision-probability surrogate)."""

from collide2d_tpu_torch.models import collision_model, learned

__all__ = ["collision_model", "learned"]
