"""The cards a run uses: the look for them, their names and memory peak."""

from __future__ import annotations

import subprocess

import torch


class NoDevice(RuntimeError):
    """Fewer cards than the cell asks for."""


def require_cuda(chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    have = torch.cuda.device_count()
    if have < chips:
        raise NoDevice(f"the cell asks for {chips} cards, {have} visible")


def describe(device: str, chips: int) -> dict:
    """The result line's ``device`` (memory filled in by `memory_peak`)."""
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def memory_peak(device: str, chips: int) -> int:
    """Peak allocated bytes on the fullest card used, since the process
    started (set-up included)."""
    if device == "cpu":
        return 0
    return max(int(torch.cuda.max_memory_allocated(i)) for i in range(chips))


def power_limit() -> str:
    """``name, power.limit`` of card 0 as nvidia-smi reads it, or ''."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return ""
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else ""
