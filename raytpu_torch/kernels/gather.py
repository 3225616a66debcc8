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
  by every channel gathered with it, its plan: the stable sort's
  permutation, the sorted rows and each row's segment of the sorted
  order. For CUDA tensors the hand-written radix sort
  ``csrc/index_sort.cu`` makes it (only the index's ceil(log2 n_rows)
  bits; each row's first entry searched in the sorted rows); for CPU tensors
  its plain version, ``torch.sort(stable=True)`` + ``searchsorted``
  (``sorted_plan_reference``). A stable sort has one answer: the two
  agree bit for bit;
* ``segment_sum`` sums each row's segment of every channel in ray order,
  by the hand-written kernel ``csrc/segment_sum.cu`` for CUDA tensors (no
  float atomics; two launches give the same bits; the channels read where
  autograd left them) and by its plain version, ``index_add_``, for CPU
  tensors (serial on the CPU).

Replaces no TPU kernel (``raytpu``'s gathers are XLA's).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch import Tensor

launches = 0        # segment-sum launches (CPU calls do not count)
sort_launches = 0   # index-sort launches (CPU calls do not count)


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
        sorted entry (n_rows + 1 of them, the last B). The kernel
        ``csrc/index_sort.cu`` for CUDA tensors, the plain version for CPU
        tensors."""
        if self._plan is None:
            if self.idx.device.type == "cuda":
                self._plan = _sort_launch(self.idx, self.n_rows)
            elif self.idx.device.type == "cpu":
                self._plan = sorted_plan_reference(self.idx, self.n_rows)
            else:
                raise NotImplementedError(
                    f"sorted_plan: no kernel for {self.idx.device}")
        return self._plan


def sorted_plan_reference(idx: Tensor, n_rows: int
                          ) -> tuple[Tensor, Tensor, Tensor]:
    """Plain version of the plan: ``torch.sort(stable=True)``, then
    ``searchsorted`` of every row, as int32."""
    seg, perm = torch.sort(idx, stable=True)
    rows = torch.arange(n_rows + 1, device=idx.device, dtype=seg.dtype)
    off = torch.searchsorted(seg, rows)
    return perm.to(torch.int32), seg.to(torch.int32), off.to(torch.int32)


def segment_sum_reference(g, index: GatherIndex) -> Tensor:
    """Plain version: (C, B) cotangents, or C (B,) ones, -> (C, n_rows)
    row sums by ``index_add_``."""
    g = g if isinstance(g, Tensor) else torch.stack(list(g))
    out = g.new_zeros((g.shape[0], index.n_rows))
    return out.index_add_(1, index.idx, g)


_ARGTYPES = ([ctypes.c_void_p] * 6         # chans perm seg off part out
             + [ctypes.c_int] * 3          # n_ch n n_rows
             + [ctypes.c_void_p])          # stream
_SORT_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]  # idx n n_rows
                  + [ctypes.c_void_p] * 5)  # perm seg off scratch stream
_MAX_ENTRIES = 2 ** 31 - 2 ** 16


def _bind_segment_sum(lib):
    fn = lib.raytpu_segment_sum
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    tiles = lib.raytpu_segment_sum_tiles
    tiles.argtypes, tiles.restype = [ctypes.c_void_p], None
    out = (ctypes.c_int * 3)()
    tiles(out)
    return fn, tuple(out)


def _bind_index_sort(lib):
    fn, sizes = lib.raytpu_index_sort, lib.raytpu_index_sort_sizes
    fn.argtypes, fn.restype = _SORT_ARGTYPES, ctypes.c_int
    sizes.argtypes, sizes.restype = [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p], None
    return fn, sizes


_BIND = {"segment_sum": _bind_segment_sum, "index_sort": _bind_index_sort}
_BOUND: dict = {}


def _bound(name: str):
    """The entry points of ``csrc/<name>.cu``'s library, their argtypes
    set once for each library loaded (a variant build swapped into
    ``_build`` is bound anew)."""
    from raytpu_torch.kernels import _build

    lib = _build.load(name)
    got = _BOUND.get(name)
    if got is None or got[0] is not lib:
        got = _BOUND[name] = (lib, _BIND[name](lib))
    return got[1]


def sort_sizes(n: int, n_rows: int) -> tuple[int, int, int, int]:
    """(int32 scratch entries, radix passes, entries a block of a pass,
    rows a block of the offsets) of the built sort for ``n`` entries over
    ``n_rows`` rows."""
    out = (ctypes.c_longlong * 4)()
    _bound("index_sort")[1](n, n_rows, out)
    return tuple(out)


def _sort_launch(idx: Tensor, n_rows: int) -> tuple[Tensor, Tensor, Tensor]:
    """Launch ``csrc/index_sort.cu`` on the current stream. perm, seg, off
    and the scratch planes are one allocation."""
    global sort_launches
    if idx.dtype != torch.int64 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"index_sort kernel: want a contiguous (B,) int64 "
                         f"index, got {idx.dtype} {tuple(idx.shape)}")
    n = idx.shape[0]
    if n > _MAX_ENTRIES or not 1 <= n_rows <= 2 ** 30:
        raise ValueError(f"index_sort kernel: at most {_MAX_ENTRIES} entries "
                         f"and 1 to 2^30 rows, got {n} and {n_rows}")
    fn, _ = _bound("index_sort")
    buf = torch.empty(2 * n + n_rows + 1 + sort_sizes(n, n_rows)[0],
                      dtype=torch.int32, device=idx.device)
    perm, seg = buf[:n], buf[n:2 * n]
    off = buf[2 * n:2 * n + n_rows + 1]
    ptr = buf.data_ptr()
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    with torch.cuda.device(idx.device):
        err = fn(idx.data_ptr(), n, n_rows, ptr,
                 ptr + 4 * n, ptr + 8 * n, ptr + 4 * (2 * n + n_rows + 1),
                 stream)
    if err != 0:
        raise RuntimeError(f"index_sort kernel launch failed: cudaError {err}")
    sort_launches += 1
    return perm, seg, off


def kernel_tiles() -> tuple[int, int]:
    """(tile, heavy) of the built kernel: it scans ``tile`` sorted entries
    a block, and sums a row that spans more than ``heavy`` tiles by the
    whole warp from its second-level partials (one a ``tile`` tiles)."""
    return _bound("segment_sum")[1][:2]


def _channels(g) -> list[Tensor]:
    """The channels of (C, B) cotangents or of a sequence of (B,) ones."""
    return list(g.unbind(0)) if isinstance(g, Tensor) else list(g)


def _launch(g, index: GatherIndex) -> Tensor:
    """Launch ``csrc/segment_sum.cu`` on the current stream: ``g`` (C, B)
    or C (B,) contiguous f32 cotangents on the index's card, read in
    place (their pointers are the kernel's arguments)."""
    global launches
    fn, (tile, _, max_ch) = _bound("segment_sum")
    dev, b = index.idx.device, index.idx.shape[0]
    card = index.idx.get_device()

    def fits(x, dim):
        return (x.dtype is torch.float32 and x.dim() == dim
                and x.shape[-1] == b and x.is_contiguous()
                and x.get_device() == card)

    if isinstance(g, Tensor):
        ok, c = fits(g, 2), g.shape[0]
        ptrs = [g.data_ptr() + 4 * b * i for i in range(c)] if ok else []
    else:
        chans = list(g)
        ok, c = all(fits(x, 1) for x in chans), len(chans)
        ptrs = [x.data_ptr() for x in chans]
    if not ok:
        raise ValueError(f"segment_sum kernel: want contiguous f32 (C, B) or "
                         f"(B,) cotangents on the index's {dev}, B = {b}")
    if b > _MAX_ENTRIES:
        raise ValueError(f"segment_sum kernel: at most {_MAX_ENTRIES} entries")
    perm, seg, off = index.sorted_plan()
    n_tiles = -(-b // tile)
    out = torch.empty((c, index.n_rows), dtype=torch.float32, device=dev)
    part = torch.empty(min(c, max_ch) * (b + n_tiles), dtype=torch.float32,
                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for c0 in range(0, c, max_ch):
        group = ptrs[c0:c0 + max_ch]
        with torch.cuda.device(dev):
            err = fn((ctypes.c_void_p * len(group))(*group), perm.data_ptr(),
                     seg.data_ptr(), off.data_ptr(), part.data_ptr(),
                     out.data_ptr() + 4 * index.n_rows * c0, len(group), b,
                     index.n_rows, stream)
        if err != 0:
            raise RuntimeError(f"segment_sum kernel launch failed: "
                               f"cudaError {err}")
        launches += 1
    return out


def segment_sum(g, index: GatherIndex) -> Tensor:
    """(C, B) cotangents, or C (B,) ones, in the index's ray order ->
    (C, n_rows): each row's sum over the entries that gathered it. The
    kernel for CUDA tensors, the plain version for CPU tensors."""
    dev = index.idx.device
    if dev.type == "cuda":
        return _launch(g, index)
    if dev.type == "cpu":
        return segment_sum_reference(g, index)
    raise NotImplementedError(f"segment_sum: no kernel for {dev}")


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
        sums = segment_sum([grads[i].to(torch.float32).contiguous()
                            for i in want], ctx.index)
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
