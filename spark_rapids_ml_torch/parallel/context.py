#
# The device an estimator runs on: the one-GPU port of `TpuContext`
# (spark_rapids_ml_tpu/parallel/context.py).
#
# Device rule.  Entry points run on "cuda:0" unless the caller asks for
# the CPU, through `set_default_device("cpu")` or the environment
# variable SPARK_RAPIDS_ML_TORCH_DEVICE.  With no CUDA device and no such
# request they raise; they never carry on silently on the CPU.  This is a
# port-only accessor, not a conf key.
#
from __future__ import annotations

import os
from typing import Optional, Union

import torch

_ENV_DEVICE = "SPARK_RAPIDS_ML_TORCH_DEVICE"
_DEFAULT_DEVICE = "cuda:0"
_device_override: Optional[str] = None


def set_default_device(device: Union[str, torch.device, None]) -> None:
    """Choose the device entry points run on ("cpu", "cuda", "cuda:1", ...).
    None goes back to the environment variable, then to "cuda:0"."""
    global _device_override
    _device_override = None if device is None else str(torch.device(device))


def get_default_device() -> str:
    """The requested device name, before any check that it exists."""
    if _device_override is not None:
        return _device_override
    return os.environ.get(_ENV_DEVICE) or _DEFAULT_DEVICE


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """The device to run on: `device`, else the default.  Raises when a
    CUDA device is asked for and none exists."""
    dev = torch.device(device if device is not None else get_default_device())
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{dev} was requested but PyTorch sees no CUDA device; call "
                "spark_rapids_ml_torch.set_default_device('cpu') (or set "
                f"{_ENV_DEVICE}=cpu) to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"{dev} was requested but only {torch.cuda.device_count()} "
                "CUDA device(s) exist"
            )
    return dev


class DeviceContext:
    """Context manager around one fit or search: resolves `num_workers` to
    the device.  One GPU only: num_workers in {None, 1}."""

    def __init__(self, num_workers: Optional[int] = None,
                 device: Union[str, torch.device, None] = None) -> None:
        if num_workers is not None and int(num_workers) > 1:
            raise NotImplementedError(
                f"num_workers={num_workers}: the port runs on one device; "
                "several GPUs are the 'Multi-GPU and multi-process' item of "
                "ROADMAP.md"
            )
        self._device = device
        self.device: Optional[torch.device] = None

    def __enter__(self) -> "DeviceContext":
        self.device = resolve_device(self._device)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.device = None
