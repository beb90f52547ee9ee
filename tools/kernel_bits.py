#!/usr/bin/env python3
"""Hold the float32 smoother kernels to another tree's bits on the card.

    python3 tools/kernel_bits.py save ROOT OUT.pt   # run ROOT's kernels
    python3 tools/kernel_bits.py compare A.pt B.pt  # exit 1 if any differ

`save` imports `amgx_tpu_torch` and `chip_smoke` from the tree at ROOT
(a checkout, or a `git archive` of another commit unpacked in a
directory that .gitignore lists), builds its kernels and saves the
float32 outputs of B2, B3, B4 (with B4's dot), their coefficient modes,
and B5 / B5-mf on the 32^3 hierarchies (V, W, F, with and without the
dot), at the flagship's 128^3 level-0 shapes with seeded inputs
(`chip_smoke.grid_case`, `tail_cases`). `compare` prints, per output,
whether the two files hold the same bits and the largest difference. A
change that only adds kernel forms (another operand dtype) should keep
every float32 output: run `save` for both trees in one call, then
`compare`. Needs a CUDA card; imports no JAX.
"""
import json
import os
import sys


def save(root, out):
    import torch
    sys.path.insert(0, os.path.abspath(root))
    import amgx_tpu_torch as amgx
    import chip_smoke as cs
    from amgx_tpu_torch.ops import cuda_build
    from amgx_tpu_torch.ops import cuda_spmv as K
    from amgx_tpu_torch.ops import cuda_tail as T
    from amgx_tpu_torch.ops import stencil as mf
    from amgx_tpu_torch.solvers.relaxation import (l1_strengthened_diag,
                                                   safe_recip)
    if not os.path.dirname(amgx.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {amgx.__file__}, not ROOT's package")
    cuda_build.build_all()
    dev = torch.device("cuda", 0)
    A, xfer, taus, b, x, xc = cs.grid_case(torch, amgx, (128, 128, 128), dev)
    vals, offs, ctab, agg = A.dia_vals, A.dia_offsets, xfer["ctab"], \
        xfer["agg"]
    st = mf.detect_stencil(A)
    dinv = safe_recip(l1_strengthened_diag(A))
    t2 = torch.full((2,), 0.75, device=dev)
    res = {}
    res["B2_x"], res["B2_r"] = K.dia_smooth(vals, offs, taus, b, x)
    res["B3_x"], res["B3_bc"] = K.dia_smooth_restrict(vals, offs, taus, b,
                                                      x, ctab)
    res["B4"] = K.dia_prolong_smooth(vals, offs, taus, b, x, xc, agg)
    res["B4dot_x"], d = K.dia_prolong_smooth(vals, offs, t2, b, x, xc, agg,
                                             dinv, with_dot=True)
    res["B4dot_d"] = d.reshape(1)
    res["B2mf_x"], res["B2mf_r"] = K.dia_smooth_mf(st, taus, b, x)
    res["B3mf_x"], res["B3mf_bc"] = K.dia_smooth_restrict_mf(st, taus, b, x,
                                                             ctab)
    res["B4mf"] = K.dia_prolong_smooth_mf(st, taus, b, x, xc, agg)
    for mode in ("slab", "mf"):
        for label, (spec, arrs, with_dot, bb, xx) in cs.tail_cases(
                torch, amgx, T, dev, mode).items():
            r = T.dia_coarse_tail(spec, arrs, bb, xx, with_dot)
            r = r if with_dot else (r,)
            for i, v in enumerate(r):
                res[f"B5 {mode} {label} {i}"] = v.reshape(-1)
    torch.cuda.synchronize()
    torch.save({k: v.detach().cpu() for k, v in res.items()}, out)
    print(json.dumps({"saved": out, "outputs": len(res),
                      "device": torch.cuda.get_device_name(0)}))


def compare(a_path, b_path):
    import torch
    a, b = torch.load(a_path), torch.load(b_path)
    out = {k: {"same_bits": bool(torch.equal(a[k], b[k])),
               "max_abs_diff": float((a[k].double() - b[k].double())
                                     .abs().max())}
           for k in a}
    same = sorted(a) == sorted(b) and all(v["same_bits"]
                                          for v in out.values())
    print(json.dumps({"same_bits": same, "outputs": out}))
    return 0 if same else 1


def main():
    if len(sys.argv) == 4 and sys.argv[1] == "save":
        return save(sys.argv[2], sys.argv[3]) or 0
    if len(sys.argv) == 4 and sys.argv[1] == "compare":
        return compare(sys.argv[2], sys.argv[3])
    print(__doc__.split("\n\n")[1], file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
