"""Deterministic segment reductions for the setup phase.

Every float sum of the classical setup that feeds a comparison (strength
row sums, the D2 sums, truncation row sums, the Galerkin values) runs
through `ordered_segment_sum`: each segment is added strictly left to
right, starting from 0, with one elementwise add per position. That is
the order of the JAX package's sorted `segment_sum` on the CPU, and the
same bits on the CPU and on the card -- `index_add_` / `scatter_add_`
on CUDA sum in an order that changes from run to run, and one ulp is
enough to flip a truncation tie. Maxima (`segment_max`) are exact in any
order.
"""
from __future__ import annotations

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


def ordered_segment_sum(values: torch.Tensor,
                        starts: torch.Tensor) -> torch.Tensor:
    """out[s] = 0 + values[starts[s]] + values[starts[s] + 1] + ...,
    added left to right. Segments run longest first, so position j of
    every segment longer than j is one contiguous gather-add: as many
    steps as the longest segment, nnz work in all, one host read."""
    starts = starts.long()
    nseg = starts.numel() - 1
    out = torch.zeros(nseg, dtype=values.dtype, device=values.device)
    if nseg <= 0 or values.numel() == 0:
        return out
    lengths = starts[1:] - starts[:-1]
    order = torch.argsort(lengths, descending=True, stable=True)
    lsorted = lengths[order]
    first = starts[:-1][order]
    longest = int(lsorted[0])
    # live[j] = number of segments longer than j
    hist = torch.bincount(lsorted, minlength=longest + 1)
    live = (nseg - torch.cumsum(hist, 0))[:longest].tolist()
    acc = torch.zeros(nseg, dtype=values.dtype, device=values.device)
    for j, k in enumerate(live):
        acc[:k] += values[first[:k] + j]
    out[order] = acc
    return out


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
