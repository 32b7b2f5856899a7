"""Carrying state across from the JAX package.

What carries across is configuration, the fixed BRIEF pattern (ops/orb.py
draws it from the same seed), a landmark map, a tracker's state, a HOG
detector's linear SVM and a background model's state. The tests build a
nested dict with `dataclasses.asdict` on a JAX config and rebuild the
port's config from it here, feed both engines the same landmark map
through `load_map`, both trackers the same snapshot through
`tracker_snapshot`, both detectors the same weights through
`hog_detector`, both background subtractors the same mid-sequence
state through `background_state`, and both cascade detectors the same
trained cascade through `cascade_model` / `lbp_cascade_model`.
Everything arrives as numpy or plain Python; nothing here imports the
JAX package. DNN weights cross in the model files themselves: the same
ONNX, Darknet, Caffe or TF bytes go through both packages' importers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opencv_tpu_torch.core.config import LKConfig, MatchConfig, ORBConfig
from opencv_tpu_torch.device import resolve_device
from opencv_tpu_torch.ops import bgsegm
from opencv_tpu_torch.ops.cascade import CascadeModel, LBPCascadeModel
from opencv_tpu_torch.slam.vo import VOConfig
from opencv_tpu_torch.tbd.tracker import Track

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


def tracker_snapshot(snapshot, device=None):
    """A JAX `Tracker.get_tracks()` snapshot (its Tracks, `next_id`, and
    the numpy filter state (x, P) or None) as the port's snapshot for
    `Tracker.set_tracks`: Track records with copied f32 boxes, the filter
    state on the device."""
    tracks, next_id, kf = snapshot
    dev = resolve_device(device)
    ported = [Track(**{f.name: getattr(t, f.name) for f in dataclasses.fields(Track)})
              for t in tracks]
    for t in ported:
        t.bbox = np.array(t.bbox, np.float32)
    if kf is not None:
        kf = tuple(torch.as_tensor(np.array(a, np.float32), device=dev) for a in kf)
    return ported, int(next_id), kf


def hog_detector(weights: np.ndarray, bias: float, device=None):
    """A HOG linear SVM (numpy weights [descriptor_dim] and a bias) as the
    port's (f32 weight tensor on the device, float bias)."""
    w = torch.as_tensor(np.asarray(weights, np.float32).reshape(-1), device=resolve_device(device))
    return w, float(bias)


_BACKGROUND_STATES = (bgsegm.MOG2State, bgsegm.KNNState, bgsegm.GMGState, bgsegm.FGDState)


def background_state(state, device=None):
    """A JAX background model's state (MOG2State, KNNState, GMGState or
    FGDState; its arrays as numpy or anything numpy reads) as the port's
    state of the same fields: f32 tensors on the device, and the frame
    counter as an int."""
    fields = tuple(state._fields)
    cls = next((c for c in _BACKGROUND_STATES if c._fields == fields), None)
    if cls is None:
        raise KeyError(f"not a background model state: {fields}")
    dev = resolve_device(device)
    vals = []
    for f in fields:
        v = np.asarray(getattr(state, f))
        vals.append(int(v) if v.ndim == 0 else torch.as_tensor(np.array(v, np.float32), device=dev))
    return cls(*vals)


def cascade_model(m) -> CascadeModel:
    """A JAX `CascadeModel` (numpy fields) as the port's: copied arrays of
    the same dtypes, the window as a tuple of ints."""
    return CascadeModel(
        window=tuple(int(v) for v in m.window),
        rects=np.array(m.rects, np.float32),
        feature=np.array(m.feature, np.int32),
        threshold=np.array(m.threshold, np.float32),
        left=np.array(m.left, np.float32),
        right=np.array(m.right, np.float32),
        stage_offsets=np.array(m.stage_offsets, np.int32),
        stage_thresholds=np.array(m.stage_thresholds, np.float32),
    )


def lbp_cascade_model(m) -> LBPCascadeModel:
    """A JAX `LBPCascadeModel` as the port's; the subset words keep their
    bits as uint32 (from uint32 or the XML's signed int32)."""
    return LBPCascadeModel(
        window=tuple(int(v) for v in m.window),
        rects=np.array(m.rects, np.int32),
        feature=np.array(m.feature, np.int32),
        subsets=np.asarray(m.subsets).astype(np.int64).astype(np.uint32),
        left=np.array(m.left, np.float32),
        right=np.array(m.right, np.float32),
        stage_offsets=np.array(m.stage_offsets, np.int32),
        stage_thresholds=np.array(m.stage_thresholds, np.float32),
    )


def ml_model(m, device=None):
    """A JAX ml model or result NamedTuple (`LinearModel`, `MLPModel`,
    `KernelSVM`, `GaussianNB`, `SVMSGDModel`, `Tree`, `Forest`,
    `Boosted`, `GBT`, `KMeansResult`, `GMMResult`) as the port's class of
    the same name: every array field as a tensor on `device` (the card
    unless the caller asks for the CPU), tuples of arrays as tuples of
    tensors, nested trees converted, and Python fields as they are."""
    from opencv_tpu_torch.ml import classifiers, clustering, trees

    dev = resolve_device(device)
    name = type(m).__name__
    cls = next(getattr(mod, name) for mod in (classifiers, clustering, trees) if hasattr(mod, name))

    def field(v):
        if isinstance(v, (str, int, float, bool)):
            return v
        if isinstance(v, tuple) and not hasattr(v, "_fields"):
            return tuple(field(a) for a in v)
        if hasattr(v, "_fields"):
            return ml_model(v, dev)
        return torch.as_tensor(np.array(v), device=dev)

    return cls(*(field(getattr(m, f)) for f in cls._fields))
