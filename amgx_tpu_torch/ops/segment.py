"""Deterministic segment reductions for the setup phase.

Every float sum of the setup that feeds a comparison (the classical
strength row sums, D2 sums and truncation row sums, the Galerkin values,
the pairwise matching's collapsed edge weights) runs through
`ordered_segment_sum`: each segment is added strictly left to
right, starting from 0, with one elementwise add per position. That is
the order of the JAX package's sorted `segment_sum` on the CPU, and the
same bits on the CPU and on the card -- `index_add_` / `scatter_add_`
on CUDA sum in an order that changes from run to run, and one ulp is
enough to flip a truncation tie. Maxima (`segment_max`) are exact in any
order.

On a CUDA tensor (float32 or float64) `ordered_sum` is one launch of K8
(`csrc/segment.cu`: one thread a segment, adding its values in stored
order in the value's type, so the plain form's bits); its plain form,
the loop over positions below, serves CPU tensors. Launches count in
`cuda_spmv.LAUNCHES["ordered_sum"]`.
"""
from __future__ import annotations

import ctypes
import functools

import torch


def starts_from_ids(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(num_segments + 1,) int64 boundaries of sorted segment ids."""
    counts = torch.bincount(ids.long(), minlength=num_segments)
    starts = torch.zeros(num_segments + 1, dtype=torch.int64,
                         device=ids.device)
    torch.cumsum(counts, 0, out=starts[1:])
    return starts


def coalesce(rows, cols, num_cols: int):
    """(order, starts, rows_u, cols_u) of int64 COO coordinates: their
    stable (row, col) sort, the (nU + 1,) boundaries of its runs of equal
    coordinates, and the unique coordinates."""
    key, order = torch.sort(rows * int(num_cols) + cols, stable=True)
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    starts = torch.cat([torch.nonzero(first)[:, 0],
                        key.new_tensor([key.numel()])])
    ukey = key[first]
    return order, starts, ukey // num_cols, ukey % num_cols


def ordered_sum_plan(starts: torch.Tensor):
    """(order, first, live, lengths) of sorted segment boundaries: the
    segments longest first, their first positions, how many are longer
    than j for each position j, and their lengths. Made once (one host
    read), it serves every `ordered_sum` over the same segments."""
    starts = starts.long()
    nseg = starts.numel() - 1
    if nseg <= 0:
        return None
    lengths = starts[1:] - starts[:-1]
    order = torch.argsort(lengths, descending=True, stable=True)
    lsorted = lengths[order]
    longest = int(lsorted[0])
    # live[j] = number of segments longer than j
    hist = torch.bincount(lsorted, minlength=longest + 1)
    live = (nseg - torch.cumsum(hist, 0))[:longest].tolist()
    return order, starts[:-1][order], live, lsorted


@functools.lru_cache(maxsize=None)
def _lib():
    from .cuda_build import library
    lib = library("segment.cu")
    P = ctypes.c_void_p
    for fn in (lib.amgx_ordered_sum_f32, lib.amgx_ordered_sum_f64):
        fn.argtypes = [P, P, P, P, P, ctypes.c_int64, P]
        fn.restype = ctypes.c_int
    return lib


def ordered_sum_plain(values: torch.Tensor, plan, nseg: int) -> torch.Tensor:
    """`ordered_sum`'s plain form: segments run longest first, so
    position j of every segment longer than j is one contiguous
    gather-add: as many steps as the longest segment, nnz work in all,
    no host read."""
    out = torch.zeros(nseg, dtype=values.dtype, device=values.device)
    if plan is None or values.numel() == 0:
        return out
    order, first, live = plan[:3]
    acc = torch.zeros(nseg, dtype=values.dtype, device=values.device)
    for j, k in enumerate(live):
        acc[:k] += values[first[:k] + j]
    out[order] = acc
    return out


def ordered_sum(values: torch.Tensor, plan, nseg: int) -> torch.Tensor:
    """out[s] = 0 + values[starts[s]] + values[starts[s] + 1] + ...,
    added left to right over `plan` (ordered_sum_plan): the plain form
    for CPU tensors, one K8 launch on the card."""
    if values.device.type == "cpu":
        return ordered_sum_plain(values, plan, nseg)
    from .cuda_spmv import _launch, _ptr, _stream
    out = torch.zeros(nseg, dtype=values.dtype, device=values.device)
    if plan is None or values.numel() == 0:
        return out
    if values.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ordered_sum: {values.dtype}; the kernel takes "
                        f"float32 or float64")
    order, first, lengths = plan[0], plan[1], plan[3]
    for name, t in (("order", order), ("first", first),
                    ("lengths", lengths)):
        if t.device != values.device or t.dtype != torch.int64 \
                or tuple(t.shape) != (nseg,):
            raise ValueError(f"ordered_sum: plan's {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}; the kernel "
                             f"takes int64 ({nseg},) on {values.device}")
    values = values.contiguous()
    lib = _lib()
    fn = lib.amgx_ordered_sum_f64 if values.dtype == torch.float64 \
        else lib.amgx_ordered_sum_f32
    with torch.cuda.device(values.device):
        _launch("ordered_sum", fn, _ptr(values), _ptr(order.contiguous()),
                _ptr(first.contiguous()), _ptr(lengths.contiguous()),
                _ptr(out), nseg, _stream())
    return out


def ordered_segment_sum(values: torch.Tensor,
                        starts: torch.Tensor) -> torch.Tensor:
    """The ordered sum of each segment of `values` between `starts`
    (ordered_sum with a plan made for this call)."""
    nseg = starts.numel() - 1
    if nseg <= 0 or values.numel() == 0:
        return torch.zeros(max(nseg, 0), dtype=values.dtype,
                           device=values.device)
    return ordered_sum(values, ordered_sum_plan(starts), nseg)


def ordered_rows_sum(values: torch.Tensor) -> torch.Tensor:
    """0 + values[0] + values[1] + ... over the leading axis, added left
    to right: the ordered sum of every column's segment (the order
    `ordered_segment_sum` adds a segment in), one elementwise add a
    row."""
    out = torch.zeros(values.shape[1:], dtype=values.dtype,
                      device=values.device)
    for row in values:
        out = out + row
    return out


def ordered_segment_sum_plain(values: torch.Tensor,
                              starts: torch.Tensor) -> torch.Tensor:
    """`ordered_segment_sum` in plain PyTorch on any device (the
    comparisons of the kernels whose plain forms sum segments)."""
    nseg = starts.numel() - 1
    if nseg <= 0 or values.numel() == 0:
        return torch.zeros(max(nseg, 0), dtype=values.dtype,
                           device=values.device)
    return ordered_sum_plain(values, ordered_sum_plan(starts), nseg)


def segment_sum(values: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Ordered sum over SORTED segment ids (empty segments give 0)."""
    return ordered_segment_sum(values, starts_from_ids(ids, num_segments))


def segment_max(values: torch.Tensor, ids: torch.Tensor, num_segments: int,
                initial: float = float("-inf")) -> torch.Tensor:
    """max over each segment (any order), `initial` where empty."""
    out = torch.full((num_segments,), initial, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, ids.long(), values, "amax",
                               include_self=True)


def segment_any(mask: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = torch.zeros(num_segments, dtype=torch.int32, device=mask.device)
    return out.index_add_(0, ids.long(), mask.to(torch.int32)) > 0
