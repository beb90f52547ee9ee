"""B10, the Galerkin RAP value kernel, with its plain PyTorch twin.

`rap_values` replaces `_rap_kernel_program` (amgx_tpu/ops/pallas_spgemm.py:
261, body `_rap_kernel`): the value phase of a planned R A P
(ops/spgemm.py `RapPlan`),

    t[k] = sum_{e in run k of stage 1} a[sa[e]] * p[sp[e]]
    c[u] = sum_{f in run u of stage 2} r[sr[f]] * t[st[f]]

each run added left to right. CUDA source `amgx_tpu_torch/csrc/rap.cu`:
two launches per call (stage 1 over T's entries, stage 2 over C's), one
thread per output entry, products and sums rounded separately, so the
kernel gives the plain twin's bits. The TPU kernel's VMEM chunking and
its RAP_MAX_CONTRIB = 64 run cap are TPU artefacts and are dropped: any
plan runs. Bound by bytes: the four index streams, the two boundary
arrays, a, p, r and t once each, and c written.

Routing as in `cuda_spmv`: the plain version for CPU tensors, the kernel
or an exception for CUDA tensors; the kernel takes float32 only (the
JAX package's `rap_kernel_ready` takes float32 only too, and the callers
route other dtypes to the plain version). Launches count in
`cuda_spmv.LAUNCHES["rap_values"]`, one per stage.

`rap_values_relabel` is the TPU kernel's relabel form (`has1=False,
has_r=False`, pallas_spgemm.py:112-118): the Galerkin product of
unsmoothed aggregation (ops/spgemm.py `AggPlan`), with no stage 1 and
no multiply,

    c[u] = sum_{f in run u} af[st[f]]

af being A's values (its external diagonal appended when the plan folds
it). Its own entry point `amgx_rap_relabel` in `rap.cu`: one thread per
coarse entry walks its run left to right with `__fadd_rn`, the bits of
the plain twin. Bound by bytes: st and the gathered af once per
candidate (8 B), starts2 and c once per coarse entry. Launches count in
`LAUNCHES["rap_values_relabel"]`, one per call.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_spmv import _check, _launch, _ptr, _stream
from .segment import ordered_segment_sum

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    from .cuda_build import library
    lib = library("rap.cu")
    lib.amgx_rap_stage.argtypes = [_P, _P, _P, _P, _P, _P, _I, _P]
    lib.amgx_rap_stage.restype = _I
    lib.amgx_rap_relabel.argtypes = [_P, _P, _P, _P, _I, _P]
    lib.amgx_rap_relabel.restype = _I
    return lib


def rap_values_plain(plan, a, r, p, segsum=ordered_segment_sum):
    """The value phase in PyTorch: two gathers, a product and an ordered
    segment sum per stage (the JAX package's `_rap_values_slab` with its
    segments added left to right). The sums take K8 on the card (the
    float64 Galerkin's route); `segsum=ordered_segment_sum_plain` keeps
    the whole phase in plain PyTorch (B10's comparisons)."""
    t = segsum(a[plan.sa.long()] * p[plan.sp.long()], plan.starts1)
    return segsum(r[plan.sr.long()] * t[plan.st.long()], plan.starts2)


def rap_values(plan, a, r, p):
    """B10: the coarse values of R A P through `plan` (a, r, p: the
    value vectors of A, R and P). Returns a new (nU,) tensor."""
    if a.device.type == "cpu":
        return rap_values_plain(plan, a, r, p)
    nT, nU = plan.nT, plan.nU
    _check("rap_values", None, max(nT, 1),
           {"a": (a, (a.shape[0],)), "p": (p, (p.shape[0],)),
            "r": (r, (r.shape[0],))},
           {"sa": (plan.sa, (plan.sa.shape[0],)),
            "sp": (plan.sp, (plan.sa.shape[0],)),
            "starts1": (plan.starts1, (nT + 1,)),
            "sr": (plan.sr, (plan.sr.shape[0],)),
            "st": (plan.st, (plan.sr.shape[0],)),
            "starts2": (plan.starts2, (nU + 1,))})
    lib = _lib()
    with torch.cuda.device(a.device):
        t = torch.empty(nT, dtype=torch.float32, device=a.device)
        out = torch.empty(nU, dtype=torch.float32, device=a.device)
        _launch("rap_values", lib.amgx_rap_stage, _ptr(a), _ptr(p),
                _ptr(plan.sa), _ptr(plan.sp), _ptr(plan.starts1), _ptr(t),
                nT, _stream())
        _launch("rap_values", lib.amgx_rap_stage, _ptr(r), _ptr(t),
                _ptr(plan.sr), _ptr(plan.st), _ptr(plan.starts2),
                _ptr(out), nU, _stream())
    return out


def rap_values_relabel_plain(plan, af, segsum=ordered_segment_sum):
    """The relabel value phase in PyTorch: one gather and an ordered
    segment sum (the JAX package's `_rap_values_slab` with has1=False,
    has_r=False, its segments added left to right); `segsum` as in
    `rap_values_plain`."""
    return segsum(af[plan.st.long()], plan.starts2)


def rap_values_relabel(plan, af):
    """B10's relabel form: the coarse values of the aggregation Galerkin
    through `plan` (an ops/spgemm.py AggPlan) from the folded value
    vector `af`. Returns a new (nU,) tensor."""
    if af.device.type == "cpu":
        return rap_values_relabel_plain(plan, af)
    nU = plan.nU
    _check("rap_values_relabel", None, max(nU, 1),
           {"af": (af, (af.shape[0],))},
           {"st": (plan.st, (plan.st.shape[0],)),
            "starts2": (plan.starts2, (nU + 1,))})
    with torch.cuda.device(af.device):
        out = torch.empty(nU, dtype=torch.float32, device=af.device)
        _launch("rap_values_relabel", _lib().amgx_rap_relabel, _ptr(af),
                _ptr(plan.st), _ptr(plan.starts2), _ptr(out), nU, _stream())
    return out
