"""Label convex k-gon configurations on PyTorch — the extension the
reference names (README.md:3 "arbitrary convex polygons") but never builds.

Runs on the card by default (the fused k-gon Monte Carlo kernel draws the
adaptive labeler's samples there); ``--device cpu`` runs on the host:

    python examples/polygon_labeling_torch.py [--device cpu]

The PyTorch counterpart of ``examples/polygon_labeling.py``. The same flow
is available from the CLI:

    collide2d-torch polylabel --data_in polys.npz --data_out labels.npz
"""

import argparse

import numpy as np
import torch

from collide2d_tpu_torch import (
    AdaptiveConfig,
    PolygonCollisionProbabilityModel,
    PolygonConfigs,
)
from collide2d_tpu_torch.mc import prng


def device_arg(device: str) -> torch.device:
    """The card unless ``cpu`` is asked for; a card that is not there raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the examples run on the card by default and no CUDA device "
                           "is available; pass --device cpu to run them on the host")
    return dev


def example_rows(c: int, k: int, seed: int = 0) -> dict:
    """``c`` obstacle k-gons on per-configuration ellipses with Gaussian pose
    noise (x, y, theta), as numpy arrays (the JAX example's rows)."""
    rng = np.random.default_rng(seed)
    ang = np.sort(rng.uniform(0, 2 * np.pi, (c, k)), axis=-1)
    ab = rng.uniform(0.5, 3.0, (c, 1, 2))
    return dict(
        position=rng.uniform(-6, 6, (c, 2)),
        pose_theta=rng.uniform(0, 2 * np.pi, c),
        obstacle_verts=np.stack([np.cos(ang), np.sin(ang)], axis=-1) * ab,
        std_dev=rng.uniform(0.0, 0.4, (c, 3)),
    )


# An L-shaped robot is NOT convex — decompose or hull it; here a convex
# pentagon robot (CCW, around its own origin).
ROBOT = np.array([[-1.0, -0.6], [1.0, -0.6], [1.4, 0.2], [0.0, 0.9], [-1.4, 0.2]],
                 np.float32)


def main(device: str = "cuda", configs: int = 1024, k: int = 6,
         n_samples: int = 10_000, max_samples: int = 100_000) -> dict:
    dev = device_arg(device)
    model = PolygonCollisionProbabilityModel(ROBOT)
    cfgs = PolygonConfigs.from_padded(**example_rows(configs, k), device=dev)

    # Deterministic narrow phase at zero noise (the k-gon SAT kernel on
    # the card):
    labels = model.collide(cfgs._replace(std_dev=torch.zeros_like(cfgs.std_dev)))
    rate = float(labels.float().mean())
    print(f"deterministic collision rate: {rate:.3f}")

    # Fixed-budget Monte Carlo probabilities:
    cp_fixed = model.forward(prng.PRNGKey(0), cfgs, n_samples)
    mean_fixed = float(cp_fixed.mean())
    print(f"mean cp @{n_samples // 1000}k samples: {mean_fixed:.4f}")

    # Adaptive labeling to per-bin CI accuracy (the reference's stopping
    # rule, generate_dataset.cu:243-252, on k-gons):
    cfg = AdaptiveConfig(
        accuracy_bins=(0.0, 0.1, 1.0),
        bin_accuracy=(5e-3, 1e-2),
        max_samples=max_samples,
    )
    cp, n_used, converged = model.label(prng.PRNGKey(1), cfgs, cfg)
    print(
        f"adaptive: {converged.mean():.1%} converged, "
        f"mean {n_used.mean():,.0f} samples/config, mean cp {cp.mean():.4f}"
    )
    return dict(labels=labels.cpu().numpy(), collision_rate=rate,
                cp_fixed=cp_fixed.cpu().numpy(), cp=np.asarray(cp),
                n_used=np.asarray(n_used), converged=np.asarray(converged))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=parser.parse_args().device)
