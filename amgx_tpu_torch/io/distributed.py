"""Distributed system IO on one controller (the port of
amgx_tpu/io/distributed.py; the reference's
src/distributed/distributed_io.cu).

A global system is read together with a partition vector (row -> rank
map), and its rows are renumbered so each partition is contiguous, with
the partitions consolidated onto fewer ranks on request. The result is
the renumbered global system with its `part_offsets` and `perm`; it
needs no distributed layer, and the distributed solves that consume
the offsets are ROADMAP.md Queue A item 13.

Partition-vector file formats (matching the reference reader): a raw
binary int32 array of length n, or whitespace-separated text integers.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..errors import IOError_
from ..matrix import CsrMatrix
from . import read_system as _read_system
from ._common import host


def read_partition_vector(path: str, n: Optional[int] = None) -> np.ndarray:
    """Row -> rank map from file (binary int32 or text)."""
    with open(path, "rb") as f:
        raw = f.read()
    is_text = False
    try:
        txt = raw.decode("ascii")
        is_text = bool(txt.strip()) and \
            set(txt) <= set("0123456789- \t\r\n")
    except UnicodeDecodeError:
        pass
    if is_text:
        try:
            vec = np.array(txt.split(), dtype=np.int64)
        except ValueError as e:
            raise IOError_(f"malformed text partition vector {path}: {e}")
    else:
        if len(raw) % 4:
            raise IOError_(
                f"binary partition vector {path} has size {len(raw)} "
                "not a multiple of int32")
        vec = np.frombuffer(raw, dtype=np.int32).astype(np.int64)
    if n is not None and len(vec) != n:
        raise IOError_(
            f"partition vector length {len(vec)} != matrix rows {n}")
    if len(vec) and vec.min() < 0:
        raise IOError_("partition vector has negative ranks")
    return vec


def sizes_to_partition_vector(partition_sizes, n: int) -> np.ndarray:
    """Per-rank contiguous block sizes -> row -> rank map."""
    sizes = np.asarray(partition_sizes, np.int64)
    if sizes.sum() != n:
        raise IOError_(
            f"partition_sizes sum {sizes.sum()} != matrix rows {n}")
    return np.repeat(np.arange(len(sizes)), sizes)


def consolidate_partitions(part_vec: np.ndarray, n_target: int
                           ) -> np.ndarray:
    """Map a partitioning onto fewer ranks (the read-time consolidation
    of distributed_io.cu): partitions go to target ranks in contiguous
    groups, preserving locality."""
    n_parts = int(part_vec.max()) + 1 if len(part_vec) else 0
    if n_target <= 0:
        raise IOError_("n_target must be positive")
    if n_parts <= n_target:
        return part_vec.copy()
    group = (np.arange(n_parts) * n_target) // n_parts
    return group[part_vec]


def renumber_by_partition(A: CsrMatrix, part_vec: np.ndarray,
                          b=None, x=None, n_ranks: Optional[int] = None):
    """Permute the system so each rank's rows (and matching columns) are
    contiguous, ordered by rank (the reference's renumber_to_local,
    distributed_arranger.h).

    Returns (A_perm, b_perm, x_perm, part_offsets, perm): A_perm on A's
    device, b / x permuted where they are, `part_offsets[r]` the first
    global row of rank r after renumbering and `perm` the map new index
    -> old index (numpy).
    """
    n = A.num_rows
    if len(part_vec) != n:
        raise IOError_(
            f"partition vector length {len(part_vec)} != rows {n}")
    if len(part_vec) and part_vec.min() < 0:
        raise IOError_("partition vector has negative ranks")
    perm = np.argsort(part_vec, kind="stable")   # new -> old
    iperm = np.empty(n, np.int64)
    iperm[perm] = np.arange(n)
    dev = A.device
    ip = torch.from_numpy(iperm).to(dev)
    rows, cols, vals = A.coo()
    A2 = CsrMatrix.from_coo(ip[rows], ip[cols.long()], vals, n, A.num_cols)
    nr = n_ranks if n_ranks is not None else (
        int(part_vec.max()) + 1 if len(part_vec) else 1)
    counts = np.bincount(np.asarray(part_vec, np.int64), minlength=nr)
    part_offsets = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=part_offsets[1:])

    def vperm(v):
        if v is None:
            return None
        if torch.is_tensor(v):
            return v[torch.from_numpy(perm).to(v.device)]
        return np.asarray(v)[perm]

    return A2.init(), vperm(b), vperm(x), part_offsets, perm


def read_system_distributed(path: str, partition_path: Optional[str] = None,
                            partition_vector: Optional[np.ndarray] = None,
                            partition_sizes=None,
                            num_ranks: Optional[int] = None, dtype=None,
                            device=None):
    """AMGX_read_system_distributed analog: global system + partition
    vector -> partition-contiguous system on `device` (None: the card).

    Returns (A, b, x, part_offsets, perm). Partition input precedence
    mirrors the reference reader: explicit vector, then vector file,
    then per-rank `partition_sizes` (contiguous blocks of those sizes),
    then `num_ranks` equal blocks."""
    A, b, x = _read_system(path, dtype=dtype, device=device)
    n = A.num_rows
    if partition_vector is not None:
        pv = np.asarray(partition_vector, np.int64)
        if len(pv) and pv.min() < 0:
            raise IOError_("partition vector has negative ranks")
    elif partition_path is not None:
        pv = read_partition_vector(partition_path, n)
    elif partition_sizes is not None:
        pv = sizes_to_partition_vector(partition_sizes, n)
    else:
        r = num_ranks or 1
        block = -(-n // r)
        pv = np.arange(n) // block
    if num_ranks is not None:
        pv = consolidate_partitions(pv, num_ranks)
    nr = num_ranks if num_ranks is not None else (
        int(pv.max()) + 1 if len(pv) else 1)
    return renumber_by_partition(A, pv, b, x, n_ranks=nr)


def write_system_distributed(path: str, A: CsrMatrix, b=None, x=None,
                             partition_vector=None,
                             fmt: str = "matrixmarket"):
    """AMGX_write_system_distributed analog: the global system plus the
    partition vector as a sidecar file `<path>.partition` (raw int32,
    readable back by read_partition_vector)."""
    from . import write_system as _write_system
    _write_system(path, A, b, x, fmt=fmt)
    if partition_vector is not None:
        pv = host(partition_vector).astype(np.int32)
        if len(pv) != A.num_rows:
            raise IOError_(
                f"partition vector length {len(pv)} != rows {A.num_rows}")
        with open(path + ".partition", "wb") as f:
            f.write(pv.tobytes())
