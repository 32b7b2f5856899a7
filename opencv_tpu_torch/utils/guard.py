"""Numeric sanitizers + determinism harness (port of
opencv_tpu/utils/guard.py).

The reference's story here is CV_Assert/CV_DbgAssert in debug builds and
cudaSafeCall after every kernel (core/cuda/common.hpp:74):

- `checked(fn)`: wraps a function so that a NaN or inf in any floating
  output raises ValueError — the torch analog of checkify's float
  checks, opt-in per call site like CV_DbgAssert;
- `assert_finite(tree)`: eager guard for host-side checkpoints over
  nested tuples, lists, dicts, NamedTuples and dataclasses of tensors or
  arrays;
- `determinism_check(fn, *args)`: run twice, compare the bytes of every
  output leaf — the de-facto race detector on an accelerator (a CUDA
  atomic's order, a misused stream or buffer shows up as a difference).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import numpy as np
import torch


def _leaves(tree: Any, path: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) pairs of a nested structure, paths written as JAX's
    keystr writes them: [key] for dict keys and sequence indices, .name
    for NamedTuple and dataclass fields."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif tree is not None:
        yield path, tree


def _numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _first_non_finite(tree: Any) -> tuple[str, int, int] | None:
    """(path, non-finite count, size) of the first floating leaf that holds
    a NaN or inf. A tensor is tested on its own device (one scalar read
    back), an array or scalar on the host."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if not (leaf.is_floating_point() or leaf.is_complex()):
                continue
            bad = ~torch.isfinite(leaf.detach())
            n_bad = int(bad.sum())
            if n_bad:
                return path, n_bad, leaf.numel()
            continue
        arr = np.asarray(leaf)
        if arr.dtype.kind in "fc" and not np.isfinite(arr).all():
            return path, int((~np.isfinite(arr)).sum()), arr.size
    return None


def checked(fn: Callable) -> Callable:
    """Wrap `fn` so that a non-finite value in any floating output leaf
    raises ValueError naming the leaf.

    What JAX's checkify (float_checks | index_checks) catches and this
    does not: checkify instruments every primitive inside the traced
    function, so it reports the first operation that made a NaN or inf
    even when a later `where` or reduction hides it from the output, and
    it catches out-of-bounds gathers that XLA would clamp. Here only the
    outputs are checked, after the call; a NaN that does not reach an
    output passes, and out-of-bounds indexing is left to torch itself
    (an IndexError on the CPU, a device-side assert on the card)."""

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        bad = _first_non_finite(out)
        if bad is not None:
            path, n_bad, size = bad
            raise ValueError(f"{getattr(fn, '__name__', 'fn')}: output{path} holds {n_bad} "
                             f"non-finite values of {size}")
        return out

    return wrapper


def assert_finite(tree: Any, name: str = "value") -> None:
    """Host-side eager guard: raises FloatingPointError on any non-finite
    floating leaf."""
    bad = _first_non_finite(tree)
    if bad is not None:
        path, n_bad, size = bad
        raise FloatingPointError(f"{name}{path}: {n_bad} non-finite values of {size}")


def determinism_check(fn: Callable, *args, **kwargs) -> bool:
    """Run `fn` twice; True iff every output leaf is BITWISE identical
    (same structure, shapes, dtypes and bytes)."""
    la = list(_leaves(fn(*args, **kwargs)))
    lb = list(_leaves(fn(*args, **kwargs)))
    if len(la) != len(lb):
        return False
    for (pa, x), (pb, y) in zip(la, lb):
        xa, ya = _numpy(x), _numpy(y)
        if pa != pb or xa.shape != ya.shape or xa.dtype != ya.dtype or xa.tobytes() != ya.tobytes():
            return False
    return True
