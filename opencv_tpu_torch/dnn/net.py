"""Net container: sequential/DAG execution of dnn layers (port of
opencv_tpu/dnn/net.py; analog of cv::dnn::Net, dnn.hpp:74-92).

Layers are (name, fn, input_names) records run in insertion order.
`Net` is an `nn.Module` on an explicit device: `set_input` moves numpy
and tensors there, and the importers build their weights there. The JAX
Net jits the graph into one program; here each layer runs eagerly.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from opencv_tpu_torch.device import resolve_device


class Net(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self._layers: list[tuple[str, Callable, list[str]]] = []
        self._inputs: dict[str, torch.Tensor] = {}
        self._input_names: list[str] = ["data"]

    def add_layer(self, name: str, fn: Callable, inputs: str | list[str] = "auto") -> "Net":
        """fn maps one or more input tensors to one output. inputs="auto"
        chains from the previous layer (sequential)."""
        if inputs == "auto":
            inputs = [self._layers[-1][0] if self._layers else self._input_names[0]]
        elif isinstance(inputs, str):
            inputs = [inputs]
        self._layers.append((name, fn, list(inputs)))
        return self

    def set_input(self, x, name: str = "data") -> None:
        if isinstance(x, torch.Tensor):
            self._inputs[name] = x.to(self.device)
        else:
            self._inputs[name] = torch.as_tensor(np.asarray(x), device=self.device)
        if name not in self._input_names:
            self._input_names.append(name)

    def forward(self, output_name: str | None = None) -> torch.Tensor:
        """Run the graph up to `output_name` (the last layer by default).
        Every layer that multiplies runs in exact f32 whatever the TF32
        switches, under its own `no_tf32` (dnn/layers.py)."""
        target = output_name or self._layers[-1][0]
        values = dict(self._inputs)
        with torch.no_grad():
            for name, fn, in_names in self._layers:
                values[name] = fn(*[values[n] for n in in_names])
                if name == target:
                    break
        return values[target]

    def layer_names(self) -> list[str]:
        return [n for (n, _, _) in self._layers]
