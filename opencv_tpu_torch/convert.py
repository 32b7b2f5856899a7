"""Carrying state across from the JAX package.

There are no learned weights: what carries across is configuration and
the fixed BRIEF pattern (ops/orb.py draws it from the same seed). The
tests build a nested dict with `dataclasses.asdict` on a JAX config and
rebuild the port's config from it here, and feed both engines the same
landmark map through `load_map`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opencv_tpu_torch.core.config import LKConfig, MatchConfig, ORBConfig
from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.slam.vo import VOConfig

_NESTED = {"orb": ORBConfig, "match": MatchConfig, "lk": LKConfig}


def vo_config_from_dict(d: dict) -> VOConfig:
    """VOConfig from a nested dict of plain values (unknown keys raise)."""
    names = {f.name for f in dataclasses.fields(VOConfig)}
    unknown = set(d) - names
    if unknown:
        raise KeyError(f"unknown VOConfig fields: {sorted(unknown)}")
    kw = {}
    for k, v in d.items():
        kw[k] = _NESTED[k](**v) if k in _NESTED and isinstance(v, dict) else v
    return VOConfig(**kw)


def load_map(lm_pos: np.ndarray, lm_desc: np.ndarray, lm_valid: np.ndarray, device=None):
    """(pos f32 [M,3], desc int32 [M,8], valid bool [M]) on the device from
    numpy arrays; descriptors may be uint32 (the JAX package's words) or
    int32, the bits are kept."""
    dev = resolve_device(device)
    desc = np.ascontiguousarray(lm_desc)
    if desc.dtype == np.uint32:
        desc = desc.view(np.int32)
    return (
        torch.as_tensor(np.asarray(lm_pos, np.float32), device=dev),
        torch.as_tensor(desc.astype(np.int32, copy=False), device=dev),
        torch.as_tensor(np.asarray(lm_valid, bool), device=dev),
    )
