"""Train the learned collision-probability model on a generated dataset,
on PyTorch.

The reference's dataset exists to train exactly this kind of model
(generate_dataset.cu:30-36); the reference repo stops at the data. This
walkthrough closes the loop end to end:

    python examples/train_model_torch.py [data_dir] [--device cpu]

With no ``data_dir`` it first generates a small demo dataset in a
temporary directory (removed at exit), at CPU-friendly sizes; on the card
the same code labels the production 1e7-row dataset (``collide2d-torch
generate``). Runs on the card by default; ``--device cpu`` runs on the host.
The PyTorch counterpart of ``examples/train_model.py``.
"""

import argparse
import tempfile
from pathlib import Path

import numpy as np
import torch

from collide2d_tpu_torch.data.pipeline import GenerateConfig, generate_dataset
from collide2d_tpu_torch.data.schemas import unpack_dataset_rows
from collide2d_tpu_torch.models.learned import (
    LearnedCollisionModel,
    TrainConfig,
    load_training_data,
    save_model,
    train_model,
)


def device_arg(device: str) -> torch.device:
    """The card unless ``cpu`` is asked for; a card that is not there raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the examples run on the card by default and no CUDA device "
                           "is available; pass --device cpu to run them on the host")
    return dev


def ensure_dataset(data_dir: Path, device: str, batches: int = 4, batch_size: int = 1024,
                   tables: int = 256, max_samples: int = 20_000) -> Path:
    """A demo dataset in ``data_dir`` unless one is there (the JAX
    example's sizes by default)."""
    if (data_dir / "poses.npy").exists():
        return data_dir
    print(f"generating a demo dataset in {data_dir} ...")
    generate_dataset(GenerateConfig(
        data_dir=str(data_dir), num_batches=batches, batch_size=batch_size,
        num_poses=tables, num_variances=tables, seed=0, verbose=False,
        max_samples=max_samples, bin_accuracy=(0.01, 0.01, 0.02), device=device,
    ))
    return data_dir


def run(data_dir: Path, device: str, hidden=(128, 128), epochs: int = 30,
        batch_size: int = 512) -> dict:
    features, labels = load_training_data(data_dir, device=device)
    print(f"{features.shape[0]} rows; mean cp {labels.mean():.4f}")

    cfg = TrainConfig(hidden=tuple(hidden), epochs=epochs, batch_size=batch_size,
                      learning_rate=1e-3, val_fraction=0.1, verbose=True)
    result = train_model(features, labels, cfg, device=device)
    print(f"val bce {result.val_bce:.5f}  val mae {result.val_mae:.4f}  "
          f"per-bin mae {['%.4f' % m for m in result.val_mae_per_bin]}")

    model_path = data_dir / "model.npz"
    save_model(model_path, result, cfg)
    model = LearnedCollisionModel.load(model_path, device=device)

    # predict the first batch and sanity-check against its MC labels
    rows = np.load(data_dir / "0.npy")
    positions, cp, var_idx, pose_idx = unpack_dataset_rows(rows)
    poses = np.load(data_dir / "poses.npy")
    std = np.sqrt(np.load(data_dir / "variances.npy"))
    pred = model.cp(positions, var_idx, pose_idx, poses, std)
    mae = float(np.mean(np.abs(pred - cp)))
    base = float(np.mean(np.abs(cp - cp.mean())))
    print(f"batch-0 MAE {mae:.4f} (constant-mean predictor: {base:.4f})")
    return dict(rows=int(features.shape[0]), mean_cp=float(labels.mean()),
                history=list(result.history), val_bce=float(result.val_bce),
                val_mae=float(result.val_mae), batch0_mae=mae, batch0_mean_mae=base,
                pred=np.asarray(pred))


def main(device: str = "cuda", data_dir=None, batches: int = 4, batch_size: int = 1024,
         tables: int = 256, max_samples: int = 20_000, hidden=(128, 128),
         epochs: int = 30, train_batch: int = 512) -> dict:
    dev = str(device_arg(device))
    if data_dir is not None:
        return run(Path(data_dir), dev, hidden, epochs, train_batch)
    with tempfile.TemporaryDirectory(prefix="collide2d_torch_demo_") as tmp:
        path = ensure_dataset(Path(tmp), dev, batches, batch_size, tables, max_samples)
        return run(path, dev, hidden, epochs, train_batch)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("data_dir", nargs="?", default=None,
                        help="a generated dataset (default: a demo one, made first)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()
    main(device=args.device, data_dir=args.data_dir)
