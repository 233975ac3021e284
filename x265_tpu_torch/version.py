"""Version / build info (the x265 version.cpp analog), after
x265_tpu/version.py; the build line names the PyTorch device."""

from __future__ import annotations

import subprocess
import sys

VERSION = "0.2.0"


def version_str() -> str:
    """x265_version_str analog: semantic version + git describe."""
    try:
        git = subprocess.run(
            ["git", "describe", "--always", "--dirty"],
            capture_output=True, text=True, timeout=5,
            cwd=__file__.rsplit("/", 2)[0]).stdout.strip()
    except Exception:
        git = ""
    return f"{VERSION}+{git}" if git else VERSION


def build_info_str() -> str:
    """x265_build_info_str analog: platform + device summary."""
    try:
        import torch
        ndev = torch.cuda.device_count() if torch.cuda.is_available() else 0
        backend = f"torch {torch.__version__}, cuda" if ndev else \
            f"torch {torch.__version__}, cpu"
    except Exception:
        backend, ndev = "none", 0
    return (f"x265_tpu_torch {version_str()} [python "
            f"{sys.version_info.major}.{sys.version_info.minor}, "
            f"backend {backend} x{ndev}]")
