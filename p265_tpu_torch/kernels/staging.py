"""Host -> device transfer of a dispatch's arrays: one staging buffer, one
asynchronous copy.

The counterpart of the reference's upload contract
(p265_tpu/pipeline/batch_decode.py `_pack` and `decode_batch_planes`: "one
dispatch (a few per-dtype uploads)", at the narrow dtypes of
p265_tpu/pipeline/wavefront.py `_stack_plane`).  The reference packed one
1-D buffer per dtype because XLA could slice those without bitcasts; that
layout is TPU-shaped and stays unported.  Here every leaf of a tree
(dicts, lists, tuples and None around NumPy arrays) keeps its own dtype and
shape and lies in ONE byte buffer at an offset aligned to ALIGN bytes; the
used prefix goes to the device in one copy, and each leaf comes back as a
view of the device buffer.  Bools travel as bytes.

On a CUDA device the host buffer is pinned memory taken from a ring of
StagingRing.slots buffers per device, allocated once and grown
geometrically (pinning is slow, so nothing is pinned per dispatch); the
copy is non_blocking on the current stream, into a fresh device
allocation that the caching allocator keeps alive in stream order, and an
event recorded behind it guards the slot: before the host writes a slot
again it waits for that slot's last copy.  On the CPU the same layout and
the same code fill an unpinned slot and copy it into a fresh CPU tensor.

Every leaf of one staged tree is a view of one allocation, so no consumer
may write into a leaf in place.  PyTorch's uint16 support is partial:
read a uint16 leaf through `widen`, never with arithmetic or indexing.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from p265_tpu_torch.spans import span

# leaf offsets in the staging buffer: K1 stages levels and scale_m by
# 16-byte cp.async; 64 keeps every leaf on its own cache-line boundary
ALIGN = 64
# ring depth: the pipelined worker fills dispatch N+1 while N's copy may
# still read its slot
RING_SLOTS = 3
_MIN_BYTES = 1 << 20

_DTYPES: dict = {}


def torch_dtype(dt: np.dtype) -> torch.dtype:
    """The torch dtype of NumPy dtype dt (a leaf's wire dtype)."""
    dt = np.dtype(dt)
    if dt not in _DTYPES:
        _DTYPES[dt] = torch.from_numpy(np.empty(0, dt)).dtype
    return _DTYPES[dt]


def leaves(tree) -> list:
    """The leaves of a tree (NumPy arrays, or the tensors of a staged
    tree), in the order stage() lays them out."""
    out = []

    def walk(t):
        if t is None:
            return
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            out.append(t)
    walk(tree)
    return out


def _rebuild(tree, it):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def layout(arrays: list) -> tuple:
    """-> (byte offset of each array, bytes of the buffer): each array at a
    multiple of ALIGN, in order."""
    offs, off = [], 0
    for a in arrays:
        offs.append(off)
        off += -(-a.nbytes // ALIGN) * ALIGN
    return offs, off


def fill(buf: torch.Tensor, arrays: list, offs: list) -> None:
    """Copy each array's bytes into the uint8 host tensor buf at its
    offset (a non-contiguous array is gathered by the same copy)."""
    host = buf.numpy()
    for a, o in zip(arrays, offs):
        if a.nbytes:
            np.copyto(host[o:o + a.nbytes].view(a.dtype).reshape(a.shape), a)


def views(dev: torch.Tensor, arrays: list, offs: list) -> list:
    """Each array's view of the uint8 buffer dev, at its dtype and shape."""
    return [dev[o:o + a.nbytes].view(torch_dtype(a.dtype)).view(a.shape)
            for a, o in zip(arrays, offs)]


class StagingRing:
    """The staging buffers of one device (see the module docstring)."""

    def __init__(self, device, slots: int = RING_SLOTS):
        if slots < 2:
            raise ValueError(f"a staging ring needs at least 2 slots, got "
                             f"{slots}")
        self.device = torch.device(device)
        self.pinned = self.device.type == "cuda"
        self.slots = slots
        self._bufs: list = [None] * slots
        self._events: list = [None] * slots
        self._next = 0
        self._lock = threading.Lock()

    def acquire(self, nbytes: int) -> tuple:
        """The next slot, once its last copy has read it, holding at least
        nbytes -> (slot, uint8 host tensor)."""
        i = self._next
        self._next = (i + 1) % self.slots
        if self._events[i] is not None:
            self._events[i].synchronize()
            self._events[i] = None
        buf = self._bufs[i]
        if buf is None or buf.numel() < nbytes:
            size = max(nbytes, _MIN_BYTES,
                       0 if buf is None else 2 * buf.numel())
            buf = torch.empty(size, dtype=torch.uint8,
                              pin_memory=self.pinned)
            self._bufs[i] = buf
        return i, buf

    def send(self, slot: int, buf: torch.Tensor, nbytes: int):
        """Enqueue the copy of buf's first nbytes into a fresh device
        buffer on the current stream -> the device buffer."""
        dev = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
        dev.copy_(buf[:nbytes], non_blocking=self.pinned)
        if self.pinned:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._events[slot] = ev
        return dev

    def stage(self, tree, stats: dict | None = None):
        with span(stats, "upload"):
            arrays = [np.asarray(a) for a in leaves(tree)]
            offs, nbytes = layout(arrays)
            if not nbytes:
                dev = torch.empty(0, dtype=torch.uint8, device=self.device)
            else:
                with self._lock:
                    slot, buf = self.acquire(nbytes)
                    fill(buf, arrays, offs)
                    dev = self.send(slot, buf, nbytes)
            out = _rebuild(tree, iter(views(dev, arrays, offs)))
        if stats is not None:
            stats["h2d_bytes"] = stats.get("h2d_bytes", 0) + nbytes
            stats["h2d_copies"] = stats.get("h2d_copies", 0) + (nbytes > 0)
        return out


_RINGS: dict = {}
_RINGS_LOCK = threading.Lock()


def _key(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def ring(device, slots: int | None = None) -> StagingRing:
    """The process's staging ring of `device`; with slots, a new ring of
    that depth replaces it (the card test runs the minimum, 2)."""
    key = _key(device)
    with _RINGS_LOCK:
        if slots is not None or key not in _RINGS:
            _RINGS[key] = StagingRing(key, slots or RING_SLOTS)
        return _RINGS[key]


def stage(tree, device, stats: dict | None = None):
    """A tree (dicts, lists, tuples, None) of NumPy arrays -> the same tree
    with each leaf a tensor on `device` at its own dtype and shape, every
    leaf a view of one buffer filled by ONE copy.  stats: optional dict
    accumulating upload_s and upload_cpu_s (host seconds to the enqueued
    copy, the fill included; spans.span), h2d_bytes and h2d_copies."""
    return ring(device).stage(tree, stats)


def per_leaf(tree, device):
    """Plain version of stage: one copy a leaf (what stage replaced; the
    reference that tests and chip_smoke.py hold stage against)."""
    it = (torch.from_numpy(np.array(a)).to(device) for a in leaves(tree))
    return _rebuild(tree, it)


def widen(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A staged integer leaf at `dtype` (int32 or int64) on its device: a
    uint16 leaf is reinterpreted as int16 and masked, since PyTorch's
    uint16 arithmetic is partial; any other dtype is cast (no copy when
    it is already `dtype`)."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(dtype) & 0xFFFF
    return t.to(dtype)
