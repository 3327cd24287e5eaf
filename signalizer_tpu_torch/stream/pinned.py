"""Host arrays to one device through reused pinned buffers.

A copy from pageable host memory to a GPU waits for the stream; one from
pinned memory is queued and the host goes on. :class:`PinnedUpload` keeps
``DEPTH`` pinned buffers, each with its event, and hands them out in turn:
each upload writes its array into the next buffer, queues one asynchronous
copy from it and records the buffer's event; a buffer is written again
only after the copy out of it has finished (its event, which by then has
almost always passed).
"""

from __future__ import annotations

import numpy as np
import torch

DEPTH = 2  # pinned buffers an uploader hands out in turn


class PinnedUpload:
    """Float32 host arrays to ``device`` without a host-device sync.

    ``upload(data)`` returns a new float32 tensor on the device with
    ``data``'s shape and values. On a CPU device it is
    ``torch.from_numpy`` of the C-ordered float32 array (no copy where
    ``data`` already is one), as a plain ``.to("cpu")`` gives.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self._buffers = [None] * DEPTH
        self._events = [torch.cuda.Event() for _ in range(DEPTH)] if self.device.type == "cuda" else []
        self._next = 0

    def upload(self, data) -> torch.Tensor:
        data = np.asarray(data, dtype=np.float32, order="C")
        if self.device.type != "cuda":
            return torch.from_numpy(data)
        i = self._next
        self._next = (i + 1) % DEPTH
        self._events[i].synchronize()  # the copy out of this buffer has finished (at once if none was queued)
        buf = self._buffers[i]
        if buf is None or buf.numel() < data.size:
            buf = self._buffers[i] = torch.empty(max(data.size, 1), dtype=torch.float32, pin_memory=True)
        staged = buf[: data.size].view(data.shape)
        staged.numpy()[...] = data
        out = staged.to(self.device, non_blocking=True)
        self._events[i].record(torch.cuda.current_stream(self.device))
        return out


_mask_uploads: dict = {}  # device -> the PinnedUpload its masks go up through


def device_mask(valid, n: int, device) -> torch.Tensor:
    """``valid`` ([n] bool) as a contiguous [n] float32 mask on ``device``,
    1.0 where valid: a tensor already there is cast on the device; host
    values (a sequence, an array or a CPU tensor) go up through a
    :class:`PinnedUpload` kept for the device, so that no call waits for
    the stream."""
    device = torch.device(device)
    if isinstance(valid, torch.Tensor) and valid.device == device:
        mask = valid.reshape(-1).to(torch.float32).contiguous()
    else:
        host = np.asarray(valid.cpu() if isinstance(valid, torch.Tensor) else valid, dtype=bool).reshape(-1)
        uploader = _mask_uploads.get(device)
        if uploader is None:
            uploader = _mask_uploads[device] = PinnedUpload(device)
        mask = uploader.upload(host.astype(np.float32))
    if mask.numel() != n:
        raise ValueError(f"valid has {mask.numel()} entries for T={n}")
    return mask
