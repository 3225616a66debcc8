"""The scan path's winner gathers, with a deterministic backward.

The scan path (``integrator/hit.closest_hit``, ``materials/texture``)
reads each winner's scene rows by an index: the sphere and triangle
channels, the material rows, the atlas and sky texels. ``raytpu`` does
this by one-hot products (``core/gather.py``), whose transposes XLA sums
in a fixed order. The port's forward is the indexed load; its transpose,
a scatter-add, is ``index_add_`` in PyTorch, which on the card adds with
float atomics: two backward runs differ by rounding, and a few rows that
a million rays hit serialise the atomics. So ``gather`` is a
``torch.autograd.Function`` whose backward sums each row's cotangents in
a fixed order:

* ``GatherIndex`` holds one index and, made once on first use and shared
  by every channel gathered with it, its stable sort: the permutation,
  the sorted rows and each row's segment of the sorted order;
* ``segment_sum`` sums each row's segment of every channel in ray order,
  by the hand-written kernel ``csrc/segment_sum.cu`` for CUDA tensors (no
  float atomics; two launches give the same bits) and by its plain
  version, ``index_add_``, for CPU tensors (serial on the CPU).

Replaces no TPU kernel (``raytpu``'s gathers are XLA's).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch import Tensor

launches = 0   # segment-sum launches (CPU calls do not count)


class GatherIndex:
    """An (B,) int64 index into tables of ``n_rows`` rows, every entry in
    [0, n_rows), and its stable sort, made on first use
    (``sorted_plan``)."""

    def __init__(self, idx: Tensor, n_rows: int):
        self.idx = idx
        self.n_rows = n_rows
        self._plan: Optional[tuple] = None

    def sorted_plan(self) -> tuple[Tensor, Tensor, Tensor]:
        """(perm, seg, off), int32: the stable sort's permutation (sorted
        entry j is entry perm[j]), the sorted index, and each row's first
        sorted entry (n_rows + 1 of them, the last B)."""
        if self._plan is None:
            seg, perm = torch.sort(self.idx, stable=True)
            rows = torch.arange(self.n_rows + 1, device=self.idx.device,
                                dtype=seg.dtype)
            off = torch.searchsorted(seg, rows)
            self._plan = (perm.to(torch.int32), seg.to(torch.int32),
                          off.to(torch.int32))
        return self._plan


def segment_sum_reference(g: Tensor, index: GatherIndex) -> Tensor:
    """Plain version: (C, B) cotangents -> (C, n_rows) row sums by
    ``index_add_``."""
    out = g.new_zeros((g.shape[0], index.n_rows))
    return out.index_add_(1, index.idx, g)


_ARGTYPES = ([ctypes.c_void_p] * 6         # g perm seg off part out
             + [ctypes.c_int] * 3          # n_ch n n_rows
             + [ctypes.c_void_p])          # stream


def _library():
    from raytpu_torch.kernels import _build

    fn = _build.load("segment_sum").raytpu_segment_sum
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def kernel_tiles() -> tuple[int, int]:
    """(tile, heavy) of the built kernel: it scans ``tile`` sorted entries
    a block, and sums a row that spans more than ``heavy`` tiles by the
    whole warp."""
    from raytpu_torch.kernels import _build

    tiles = _build.load("segment_sum").raytpu_segment_sum_tiles
    tiles.argtypes = [ctypes.c_void_p]
    tiles.restype = None
    out = (ctypes.c_int * 2)()
    tiles(out)
    return out[0], out[1]


def _launch(g: Tensor, index: GatherIndex) -> Tensor:
    """Launch ``csrc/segment_sum.cu`` on the current stream."""
    global launches
    dev = g.device
    c, b = g.shape
    if (g.dtype != torch.float32 or not g.is_contiguous()
            or index.idx.shape != (b,) or index.idx.device != dev):
        raise ValueError(f"segment_sum kernel: want contiguous f32 (C, B) "
                         f"and a (B,) index on {dev}, got {g.dtype} "
                         f"{tuple(g.shape)}, index {tuple(index.idx.shape)} "
                         f"on {index.idx.device}")
    if b >= 2 ** 31:
        raise ValueError("segment_sum kernel: at most 2^31 - 1 entries")
    perm, seg, off = index.sorted_plan()
    part = torch.empty_like(g)
    out = torch.empty((c, index.n_rows), dtype=torch.float32, device=dev)
    fn = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(g.data_ptr(), perm.data_ptr(), seg.data_ptr(),
                 off.data_ptr(), part.data_ptr(), out.data_ptr(), c, b,
                 index.n_rows, stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: cudaError {err}")
    launches += 1
    return out


def segment_sum(g: Tensor, index: GatherIndex) -> Tensor:
    """(C, B) cotangents in the index's ray order -> (C, n_rows): each
    row's sum over the entries that gathered it. The kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if g.device.type == "cuda":
        return _launch(g, index)
    if g.device.type == "cpu":
        return segment_sum_reference(g, index)
    raise NotImplementedError(f"segment_sum: no kernel for {g.device}")


class _Gather(torch.autograd.Function):
    """planes[i][idx] for every plane; the backward sums the float planes'
    cotangents with ``segment_sum``, all of them in one call."""

    @staticmethod
    def forward(ctx, index: GatherIndex, *planes):
        ctx.index = index
        ctx.set_materialize_grads(False)
        out = [p.index_select(0, index.idx) for p in planes]
        ctx.mark_non_differentiable(*(o for o in out
                                      if not o.is_floating_point()))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        want = [i for i, g in enumerate(grads)
                if g is not None and ctx.needs_input_grad[1 + i]]
        if not want:
            return (None,) * (1 + len(grads))
        sums = segment_sum(torch.stack([grads[i].to(torch.float32)
                                        for i in want]), ctx.index)
        out = [None] * len(grads)
        for row, i in enumerate(want):
            out[i] = sums[row]
        return (None, *out)


def gather(index: GatherIndex, planes) -> list[Tensor]:
    """Each (n_rows,) plane at ``index``: plane.index_select(0, index.idx),
    differentiable in the float planes with a deterministic backward
    (``segment_sum``)."""
    planes = list(planes)
    for p in planes:
        if p.dim() != 1 or p.shape[0] != index.n_rows:
            raise ValueError(f"gather: planes must be ({index.n_rows},), got "
                             f"{tuple(p.shape)}")
    return list(_Gather.apply(index, *planes))
