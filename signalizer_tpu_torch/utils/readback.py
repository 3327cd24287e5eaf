"""Read device outputs back to the host in one go.

The views' frames are NamedTuples of tensors on the processing device.
The front ends (the offline renderers, the editor's payloads, the CLI's
arrays) read a frame's every field; field by field that is a device
synchronization a field. :func:`to_host` queues every tensor's copy and
waits once.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensors(tree, out: list) -> None:
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for leaf in tree:
            _tensors(leaf, out)


def _rebuild(tree, host: dict):
    if isinstance(tree, torch.Tensor):
        return host[id(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(leaf, host) for leaf in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(leaf, host) for leaf in tree)
    return tree


def to_host(tree):
    """A tensor, or a (named) tuple or list holding tensors, with every
    tensor read back as a numpy array: the copies off a GPU are queued
    together and waited on once. Other leaves (None, numbers, arrays) pass
    through."""
    tensors: list = []
    _tensors(tree, tensors)
    copies = {id(t): t.detach().to("cpu", non_blocking=True) for t in tensors}
    for device in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.current_stream(device).synchronize()
    host = {k: np.asarray(v.numpy()) for k, v in copies.items()}
    return _rebuild(tree, host)
