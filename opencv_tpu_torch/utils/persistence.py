"""Checkpoint / serialization (FileStorage + Algorithm::read/write
analog, reference core/src/persistence*.cpp, persistence.hpp:307). Port
of opencv_tpu/utils/persistence.py, host code in the same format: arrays
go to <path>.npz, the structure, scalars and dataclass configs to
<path>.json, so a state saved by either package loads in the other.
Tensors are saved as numpy (copied from the card when they live there);
arrays load back as numpy.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np
import torch


def _flatten(prefix: str, obj: Any, arrays: dict, meta: dict) -> None:
    if isinstance(obj, dict):
        meta[prefix + "/__type__"] = "dict"
        meta[prefix + "/__keys__"] = list(obj.keys())
        for k, v in obj.items():
            _flatten(f"{prefix}/{k}", v, arrays, meta)
    elif isinstance(obj, (list, tuple)):
        meta[prefix + "/__type__"] = "list" if isinstance(obj, list) else "tuple"
        meta[prefix + "/__len__"] = len(obj)
        for i, v in enumerate(obj):
            _flatten(f"{prefix}/{i}", v, arrays, meta)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        meta[prefix + "/__type__"] = "config"
        meta[prefix + "/__value__"] = dataclasses.asdict(obj)
        meta[prefix + "/__class__"] = type(obj).__name__
    elif isinstance(obj, torch.Tensor):
        meta[prefix + "/__type__"] = "array"
        arrays[prefix] = obj.detach().cpu().numpy()
    elif isinstance(obj, np.ndarray) or hasattr(obj, "__array__"):
        meta[prefix + "/__type__"] = "array"
        arrays[prefix] = np.asarray(obj)
    elif isinstance(obj, (int, float, str, bool)) or obj is None:
        meta[prefix + "/__type__"] = "scalar"
        meta[prefix + "/__value__"] = obj
    else:
        raise TypeError(f"cannot serialize {type(obj)} at {prefix}")


def save_state(path: str, state: dict) -> None:
    """Write state to <path>.npz + <path>.json."""
    arrays: dict[str, np.ndarray] = {}
    meta: dict[str, Any] = {}
    _flatten("root", state, arrays, meta)
    np.savez_compressed(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def _unflatten(prefix: str, arrays, meta) -> Any:
    t = meta[prefix + "/__type__"]
    if t == "dict":
        return {k: _unflatten(f"{prefix}/{k}", arrays, meta) for k in meta[prefix + "/__keys__"]}
    if t in ("list", "tuple"):
        items = [_unflatten(f"{prefix}/{i}", arrays, meta) for i in range(meta[prefix + "/__len__"])]
        return items if t == "list" else tuple(items)
    if t == "config":
        return meta[prefix + "/__value__"]  # configs reload as dicts
    if t == "array":
        return arrays[prefix]
    if t == "scalar":
        return meta[prefix + "/__value__"]
    raise TypeError(f"unknown type tag {t}")


def load_state(path: str) -> dict:
    with open(path + ".json") as f:
        meta = json.load(f)
    with np.load(path + ".npz") as npz:
        arrays = {k: npz[k] for k in npz.files}
    return _unflatten("root", arrays, meta)
