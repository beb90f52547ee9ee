"""Run-to-run determinism checker (the port of amgx_tpu/determinism.py).

Analog of src/determinism_checker.cu(:121): record bit-exact
fingerprints of intermediate vectors at named checkpoints during one
run, then verify that a repeat run reproduces every fingerprint. The
framework's algorithms are deterministic by construction (no atomics,
smallest-index tie-breaking, fixed reduction orders), and this harness
is the tool that *proves* it for any given configuration.

Usage:
    chk = DeterminismChecker()
    chk.observe("residual", r)          # during run 1
    chk.start_verification()
    chk.observe("residual", r)          # during run 2 -> raises on drift
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import numpy as np


class DeterminismError(AssertionError):
    pass


def _host_array(x) -> np.ndarray:
    """x as a numpy array with x's bytes: a tensor is copied to the host
    once (a bfloat16 tensor, which numpy lacks, as its 16-bit words)."""
    if hasattr(x, "detach"):
        import torch
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    return np.asarray(x)


def fingerprint(x) -> str:
    """Bit-exact digest of an array or tensor, computed on the host from
    its bytes (a device tensor is copied to the host once). The dtype
    string is numpy's, so a tensor and the numpy array with the same
    bytes share a fingerprint."""
    a = np.ascontiguousarray(_host_array(x))
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()[:16]


def tensor_leaves(tree) -> List:
    """Every tensor of a solve-data tree -- dicts (in key order), lists,
    tuples and dataclass objects such as CsrMatrix and StencilOperator
    (in field order) -- in a fixed order, so two trees built alike give
    their leaves in the same order."""
    import dataclasses

    import torch
    out: List = []

    def walk(node):
        if torch.is_tensor(node):
            out.append(node)
        elif isinstance(node, dict):
            for k in sorted(node, key=str):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif dataclasses.is_dataclass(node) and not isinstance(node, type):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name))

    walk(tree)
    return out


def tree_fingerprints(tree) -> List[str]:
    """`fingerprint` of each of `tensor_leaves(tree)`: a hierarchy's
    solve data (`amg.solve_data()`) fingerprinted leaf by leaf, so two
    setups compare bit for bit."""
    return [fingerprint(t) for t in tensor_leaves(tree)]


class DeterminismChecker:
    """Record-then-verify fingerprint trace (determinism_checker.cu)."""

    def __init__(self):
        self._trace: Dict[str, List[str]] = {}
        self._pos: Dict[str, int] = {}
        self._verifying = False

    def observe(self, tag: str, x):
        fp = fingerprint(x)
        if not self._verifying:
            self._trace.setdefault(tag, []).append(fp)
            return
        seq = self._trace.get(tag)
        i = self._pos.get(tag, 0)
        if seq is None or i >= len(seq):
            raise DeterminismError(
                f"determinism: unexpected extra observation for {tag!r} "
                f"(call #{i})")
        if seq[i] != fp:
            raise DeterminismError(
                f"determinism: {tag!r} call #{i} fingerprint {fp} != "
                f"recorded {seq[i]}")
        self._pos[tag] = i + 1

    def start_verification(self):
        self._verifying = True
        self._pos = {}

    def finish(self):
        """Assert the verification run covered every recorded call."""
        for tag, seq in self._trace.items():
            if self._pos.get(tag, 0) != len(seq):
                raise DeterminismError(
                    f"determinism: {tag!r} observed "
                    f"{self._pos.get(tag, 0)}/{len(seq)} calls")

    def summary(self) -> List[Tuple[str, int]]:
        return [(t, len(s)) for t, s in sorted(self._trace.items())]
