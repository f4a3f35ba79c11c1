"""Device probe and device resolution (the port's ``caffe device_query``).

``resolve_device`` is the one place a ``device=`` argument becomes a
``torch.device``: ``"cuda"`` is the default everywhere in the port, and when
no CUDA device is present it raises instead of quietly running on the CPU.
CPU runs (the tests) pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, Optional, Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def nvcc_path() -> Optional[str]:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``; None when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def nvidia_smi_line() -> Optional[str]:
    """``name, power.limit`` of the first card as nvidia-smi reports them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (subprocess.SubprocessError, OSError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def device_query() -> Dict[str, Optional[object]]:
    """What the port can run on here: torch and CUDA versions, the card's
    name and power limit, and the kernel compiler."""
    cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "cuda_runtime": torch.version.cuda,
        "cuda_available": cuda,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "device_name": torch.cuda.get_device_name(0) if cuda else None,
        "nvidia_smi": nvidia_smi_line(),
        "nvcc": nvcc_path(),
    }

