#!/usr/bin/env python3
"""Time kernels of one tree of the PyTorch/CUDA port, for comparisons in
turns: the coarse-tail kernel B5 (six forms), the CSR SpMV B8 (f32,
bf16), the temporally blocked slab B3 / B4 by split, the unfused
smoothers B2 / B2-mf by route and split, the classical level's B3w / B4w
(and B4w's dot) and B9, and the Galerkin kernels B10 and B10-relabel.

    python3 tools/kernel_turns.py [--tree DIR] [--label NAME] [--out FILE]
                                  [--sections tail,csr,slab,smooth,
                                              classical,rap]

`--tree` is the root of a checkout whose `amgx_tpu_torch` is timed (by
default this one), e.g. an unpacked `git archive` of a parent commit:
run it, this checkout, this checkout and it again, each in its own
process, in one run on one card, and compare the rows. The cases
are chip_smoke.py's, from this checkout's chip_smoke.py, at the main
path's shapes: B5 and B5-mf (and bf16) on the 32^3 hierarchies whose
cycle is the flagship 128^3's coarse tail, with and without the dot; B8
on the 128^3 CLASSICAL hierarchy's level-1 operator, P and R and on the
SIZE_2 aggregation hierarchy's level-1 operator (configs/
FGMRES_AGGREGATION_JACOBI.json), f32 and bf16, beside cuSPARSE's product
(`torch.sparse` CSR @ x). Each case is first held against its plain
PyTorch form (chip_smoke.py's limits), then timed: ms (CUDA events,
chip_smoke.py `time_ms`) and device ms (torch.profiler, `device_ms`;
None where the profile lost records). Where the tree's B5 has the phase
clock (`dia_coarse_tail(..., clock=)`), each B5 row also carries its
cluster, barrier counts and block 0's SM cycles by level, scope and
phase kind (`phase_clock`). One JSON line a case on stdout (and appended
to --out). Needs a CUDA card; imports no JAX.

`slab` (trees with the tiled slab route, ops/cuda_spmv.py `slab_route`):
chip_smoke.py's `slab_cases` on the D A D operator of the 128^3 grid
(the flagship's CHEBYSHEV_POLY and PCG's JACOBI_L1 schedules, f32 and
bf16, B4's dot), each launched with every valid split of its
applications over 1, 2 or 3 launches (`tiling.split_plans`), beside the
per-step route on the same inputs; each held to the per-step route's
bits. `smooth`: B2 and B2-mf at the flagship's 128^3 level 0 and its
64^3 level 1 (CHEBYSHEV_POLY's five steps, the level's values), float32
and bf16, with and without the residual: the tree's own wrapper (the
call the unfused cycle makes; a tree whose `dia_smooth` takes no `grid`
has one route), and in a tree with the tiled routes also the per-step
route and each split of the applications over 1, 2 or 3 launches (the
slab's launches take at most three), each held to the per-step route's
bits; each row with its launches a call and a hash of its outputs' bits
(x' first, then r). `classical`: chip_smoke.py's
`classical_cases` (B3w / B4w / B4w's dot and B9 on the 128^3 CLASSICAL
hierarchy, f32 and bf16), B3w / B4w each with the level's grid (the
cycle's call) and without it (the route of a level without a grid; a
tree without the weighted routes runs its one route both ways), each
row with its launches a call and a hash of its outputs' bits
(`bits`: x' first, then bc; the same inputs in every tree). `rap`:
B10 on the 64^3 CLASSICAL_REFINEMENT level 0 and B10-relabel on the
SIZE_2 hierarchy's level 0.
"""
import argparse
import hashlib
import importlib.util
import inspect
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = 3          # the most launches a slab call is split over here


def _chip_smoke():
    """This checkout's chip_smoke.py, whatever tree is on sys.path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_turns", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_clock(torch, T, spec, arrs, b, x, with_dot):
    """Block 0's SM clock cycles of one launch (`dia_coarse_tail`'s
    clock): in all, and per phase, summed by (level, cluster-wide or
    block-local, op), with each group's phase count; the median of five
    launches' totals picks the launch."""
    prog = T.tail_program(spec, with_dot)
    runs = []
    for _ in range(5):
        clk = torch.zeros(len(prog) + 1, dtype=torch.int64, device=x.device)
        T.dia_coarse_tail(spec, arrs, b, x, with_dot, clock=clk)
        torch.cuda.synchronize()
        c = clk.cpu().tolist()
        runs.append((c[-1] - c[0], [c[i + 1] - c[i] for i in range(len(prog))]))
    total, per = sorted(runs)[len(runs) // 2]
    ops = ("step", "restrict", "coarse", "correct", "dot")
    groups = {}
    for row, cyc in zip(prog, per):
        key = (f"l{row[1]} {'local' if row[6] & T.F_LOCAL else 'cluster'} "
               f"{ops[row[0]]}")
        n, s = groups.get(key, (0, 0))
        groups[key] = (n + 1, s + cyc)
    return {"cycles": total, "by_group": {k: {"phases": n, "cycles": s}
                                          for k, (n, s) in groups.items()}}


def slab_turns(torch, K, cs, case, A, cases, xfer):
    """The tiled slab B3 / B4 forms (`cases`: chip_smoke.py `slab_cases`
    on A) launched with each valid split of their applications, each
    against its plain form and the per-step route's bits; the per-step
    route timed as its own row."""
    from amgx_tpu_torch.ops import tiling as TL
    sms = K._sms(A.device)
    for (sched, name), c in cases.items():
        kern, plain, old = c[0], c[1], c[7]
        half = name.endswith("_bf16")
        label = f"dad_l0_128^3 {sched}"
        case(name, label, old[0], plain, old[1], half=half,
             extra={"route": "per-step"})
        for k in range(1, SPLITS + 1):
            probe = {}

            def tiled(k=k, probe=probe):
                return split_call(K, TL, kern, k, sms, probe)
            try:
                tiled()
            except ValueError:              # no such split
                continue
            plans = probe["plans"]
            case(name, label, tiled, plain, len(plans), half=half,
                 same_as=old[0],
                 extra={"route": "tiled", "split": [p.apps for p in plans],
                        "planned": [p.apps for p in TL.plan_calls(
                            plans[0].shape, sum(p.apps for p in plans),
                            plans[-1].residual, sms, plans[0].ring == 8)],
                        "tiles": [[*p.tile, p.chunk, p.blocks, p.threads,
                                   p.smem_bytes] for p in plans]})


def launched(K, fn):
    """(fn(), the launches it made, summed over the counters)."""
    before = dict(K.LAUNCHES)
    out = fn()
    return out, sum(v - before.get(k, 0) for k, v in K.LAUNCHES.items())


def smooth_turns(torch, K, cs, case, levels):
    """B2 and B2-mf on `levels` ((label, chip_smoke.py level_case)), f32
    and bf16, with and without the residual: the wrapper's route, and
    where the tree has the tiled routes the per-step route and each split
    over 1, 2 or 3 launches, held to the per-step route's bits."""
    from amgx_tpu_torch.amg.hierarchy import _cast_leaf
    from amgx_tpu_torch.ops import stencil as mf
    from amgx_tpu_torch.ops import tiling as TL
    tiled = "grid" in inspect.signature(K.dia_smooth).parameters
    for label, (A, _, taus, b, x, _) in levels:
        sms = K._sms(A.device)
        offs, grid = A.dia_offsets, A.grid_shape
        st32 = mf.detect_stencil(A)
        for dt in (torch.float32, torch.bfloat16):
            half = dt == torch.bfloat16
            vals = A.dia_vals.to(dt)
            st = _cast_leaf(st32, dt) if half else st32
            t, b_, x_ = taus.to(dt).float(), b.to(dt), x.to(dt)
            s = t.shape[0]
            for wr in (True, False):
                shape = f"{label} {'residual' if wr else 'no residual'}"
                for form in ("slab", "mf"):
                    name = ("dia_smooth" if form == "slab"
                            else "dia_smooth_mf") + ("_bf16" if half else "")
                    kw = {"st": st} if form == "mf" \
                        else {"vals": vals, "offs": offs}
                    if form == "slab":
                        wrap = (lambda wr=wr, g=grid if tiled else None:
                                K.dia_smooth(vals, offs, t, b_, x_, None,
                                             wr, **({"grid": g} if g
                                                    else {})))
                        plain = (lambda wr=wr: K.dia_smooth_plain(
                            vals, offs, t, b_, x_, None, wr))
                    else:
                        wrap = (lambda wr=wr: K.dia_smooth_mf(st, t, b_, x_,
                                                              wr))
                        plain = (lambda wr=wr: mf._xla_smooth(
                            st.spec(), st.coeffs, t, b_, x_, wr))
                    got, n_wrap = launched(K, wrap)
                    step = None
                    if tiled:
                        step = (lambda wr=wr, kw=kw: cs.smooth_step_route(
                            K, t, b_, x_, with_residual=wr, **kw))
                    case(name, shape, wrap, plain, n_wrap, half=half,
                         same_as=step,
                         extra={"route": "wrapper", "launches": n_wrap,
                                "bits": bits(torch, got)})
                    if not tiled:
                        continue
                    case(name, shape, step, plain, s + int(wr), half=half,
                         extra={"route": "per-step",
                                "launches": s + int(wr)})
                    for k in (1, 2, 3):
                        try:
                            plans = TL.split_plans(
                                grid, TL._parts(s + int(wr), k), wr, sms,
                                ring=0 if form == "mf" else 7)
                        except ValueError:      # no such split
                            continue
                        case(name, shape,
                             lambda p=plans, wr=wr, kw=kw: cs.b2_split_call(
                                 torch, K, p, t, b_, x_, wr, **{
                                     k_: v for k_, v in kw.items()
                                     if k_ != "offs"}),
                             plain, k, half=half, same_as=step,
                             extra={"route": "tiled",
                                    "split": [p.apps for p in plans],
                                    "tiles": [[*p.tile, p.chunk, p.blocks,
                                               p.threads, p.smem_bytes]
                                              for p in plans]})


def bits(torch, out):
    """A short hash of a call's outputs' bytes, in order (x', then bc or
    the dot): equal hashes, equal bits."""
    h = hashlib.sha256()
    for t in out if isinstance(out, tuple) else (out,):
        h.update(t.detach().reshape(-1).cpu().view(torch.uint8)
                 .numpy().tobytes())
        h.update(b"|")
    return h.hexdigest()[:16]


def split_call(K, TL, kern, launches, sms, probe):
    """kern() with its applications split as evenly as may be over
    `launches` launches (`tiling.split_plans`) instead of the planner's
    split; the plans it took in probe["plans"]. Raises ValueError where
    the kernel takes no such split."""
    real = K._slab_plans

    def pinned(vals, offsets, grid, dinv, x, apps, residual):
        shape = K.slab_grid(vals, offsets, grid)
        if shape is None or not TL.star_fits(TL.STAR, shape, apps):
            return None
        probe["plans"] = TL.split_plans(
            shape, TL._parts(apps, launches), residual, sms,
            ring=7 + int(dinv is not None))
        return probe["plans"]
    K._slab_plans = pinned
    try:
        return kern()
    finally:
        K._slab_plans = real


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--label", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--sections",
                    default="tail,csr,slab,smooth,classical,rap")
    args = ap.parse_args()
    sections = set(args.sections.split(","))
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("kernel_turns: PyTorch sees no CUDA device", file=sys.stderr)
        return 2
    import amgx_tpu_torch as amgx
    if hasattr(amgx, "register_print_callback"):
        # the stock file's grid table goes to stderr, away from the JSON
        # lines (a parent tree without output.py prints nothing)
        amgx.register_print_callback(lambda msg, _n: sys.stderr.write(msg))
    from amgx_tpu_torch.ops import cuda_build
    from amgx_tpu_torch.ops import cuda_csr as C
    from amgx_tpu_torch.ops import cuda_rap as R_
    from amgx_tpu_torch.ops import cuda_spmv as K
    from amgx_tpu_torch.ops import cuda_tail as T
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    label = args.label or tree
    card = cs.nvidia_smi()
    build = cuda_build.build_all()

    def emit(row):
        row = {"tree": label, "card": card, **row}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    emit({"phase": "build", "seconds": build["seconds"],
          "package": os.path.dirname(amgx.__file__),
          "ptxas": {src: cuda_build.resource_lines(build["ptxas"][src])
                    for src in ("tail.cu", "csr.cu")
                    if src in build["ptxas"]},
          "ptxas_stencil_tb": cs.tb_forms(cuda_build.resource_lines(
              build["ptxas"].get("stencil_tb.cu", "") + "\n"
              + build["ptxas"].get("stencil_tb_slab.cu", "")))})

    def case(name, shape, kern, plain, launches, lib=None, half=False,
             extra=None, same_as=None):
        got, want = kern(), plain()
        if same_as is not None:       # another route's bits (x', bc)
            outs_ = (lambda v: v if isinstance(v, tuple) else (v,))
            other = same_as()
            exact = 1 if name.endswith("_dot") else 2
            cs.check(all(torch.equal(a, b) for a, b in list(zip(
                outs_(got), outs_(other)))[:exact]),
                f"{name} at {shape}: not the per-step route's bits")
        again = kern()
        torch.cuda.synchronize()
        outs = (lambda v: v if isinstance(v, tuple) else (v,))
        same = all(torch.equal(a, b) for a, b in zip(outs(got),
                                                       outs(again)))
        if half:
            err = cs.bf16_err(torch, got, want)[1]
            limit = 1.0
        else:
            err = cs.max_err(torch, got, want)[1]
            limit = cs.LIMITS[name]
        cs.check(err <= limit, f"{name} at {shape}: {err} > {limit}")
        cs.check(same, f"{name} at {shape}: a repeat call gave other bits")
        emit({"kernel": name, "shape": shape, **(extra or {}),
              "max_rel_err": err,
              "repeat_bit_equal": same, "ms": cs.time_ms(torch, kern),
              "device_ms": cs.device_ms(torch, kern, launches)[0],
              "library_ms": None if lib is None else cs.time_ms(torch, lib)})

    # every setup before the first profile: a profile taken before a large
    # setup loses the kernel records of later ones
    A = amgx.gallery.poisson("7pt", 128, 128, 128, device=dev)
    l1 = cs.amg_of(amgx, cs.CLASSICAL, A, dev).amg.solve_data()["levels"][1]
    slv = amgx.create_solver(cs.agg_config(amgx.Config, "agg-fgmres"),
                             device=dev)
    slv.setup(amgx.gallery.poisson("7pt", 128, 128, 128,
                                   dtype=torch.float32, device=dev).init())
    mats = {"classical A1": l1["A"], "classical P1": l1["P"],
            "classical R1": l1["R"],
            "size2 A1": cs.precond_amg(slv).levels[1].A}
    lanes = "lanes" in inspect.signature(C.csr_spmv).parameters
    classical = cs.classical_cases(torch, amgx, K, C, dev, untiled=True) \
        if "classical" in sections else None
    rap = (cs.rap_case(torch, amgx, R_, dev)[0],
           cs.relabel_case(torch, R_, cs.precond_amg(slv).levels[0])[0]) \
        if "rap" in sections else None
    smooth = None
    if "smooth" in sections:
        smooth = [("l0_128^3", cs.grid_case(torch, amgx, (128,) * 3, dev)),
                  ("l1_64^3", cs.level_case(torch, amgx, cs.coarse_level(
                      torch, amgx, 128, dev), dev, 7))]
    slab = None
    if "slab" in sections and hasattr(K, "slab_route"):
        A0, xfer, taus, b, x, xc = cs.grid_case(torch, amgx, (128,) * 3,
                                                dev)
        A2 = cs.dad_operator(torch, A0)
        slab = (A2, cs.slab_cases(torch, K, A2, xfer, taus, b, x, xc),
                xfer)
    # B5: each form's main-path case, and W / F on the matrix-free levels
    forms = {("slab", False, "cheb5 V"): "dia_coarse_tail",
             ("slab", False, "jacobi_l1 V dot"): "dia_coarse_tail_dot",
             ("slab", True, "cheb5 V"): "dia_coarse_tail_bf16",
             ("mf", False, "cheb5 V"): "dia_coarse_tail_mf",
             ("mf", True, "cheb5 V"): "dia_coarse_tail_mf_bf16",
             ("mf", False, "jacobi_l1 V dot"): "dia_coarse_tail_mf_dot",
             ("mf", False, "cheb5 W"): "dia_coarse_tail_mf",
             ("mf", False, "cheb5 F"): "dia_coarse_tail_mf"} \
        if "tail" in sections else {}
    tails = {(mode, half): cs.tail_cases(torch, amgx, T, dev, mode, half)
             for mode, half in {(m, h) for m, h, _ in forms}}

    if slab is not None:
        slab_turns(torch, K, cs, case, *slab)
    if smooth is not None:
        smooth_turns(torch, K, cs, case, smooth)
    if classical is not None:
        # B3w / B4w (and B4w's dot) and B9, f32 and bf16; the launches a
        # call as this tree's wrappers count them
        cases, bf16, _, _ = classical
        for shape, named in list(cases.items()) + list(bf16.items()):
            for name, c in named.items():
                if name.startswith(("dia_", "csr_smooth")):
                    before = dict(K.LAUNCHES)
                    got = c[0]()
                    launches = sum(v - before[k]
                                   for k, v in K.LAUNCHES.items())
                    case(name, shape, c[0], c[1], launches,
                         half=name.endswith("_bf16"),
                         extra={"launches": launches,
                                "bits": bits(torch, got)})
    if rap is not None:
        for name, c in zip(("rap_values", "rap_values_relabel"), rap):
            case(name, "classical_refinement_l0_64^3" if name == "rap_values"
                 else "agg_l0_128^3", c[0], c[1], c[4], c[5])
    costs = None
    for (mode, half, tag), name in forms.items():
        spec, arrs, with_dot, b, x = tails[mode, half][tag]
        # the cluster launch's shape, where the tree has one
        shape = dict(zip(("cluster", "cluster_barriers", "block_barriers"),
                         T.launch_shape(spec, arrs, x, with_dot))) \
            if hasattr(T, "launch_shape") else {}
        if shape and costs is None:
            costs = cs.barrier_costs(torch, T, shape["cluster"])
            emit({"phase": "tail_barriers", "cluster": shape["cluster"],
                  "cluster_barrier_ms": costs[0],
                  "block_barrier_ms": costs[1]})
        if shape:
            shape["phase_clock"] = phase_clock(torch, T, spec, arrs, b, x,
                                               with_dot)
        case(name, f"tail_32^3 {tag}",
             lambda s=spec, a=arrs, w=with_dot, b=b, x=x:
             T.dia_coarse_tail(s, a, b, x, w),
             lambda s=spec, a=arrs, w=with_dot, b=b, x=x:
             T.dia_coarse_tail_plain(s, a, b, x, w), 1, half=half,
             extra=shape)

    # B8 on the classical and SIZE_2 level-1 matrices
    g = torch.Generator(device=dev).manual_seed(99)
    for tag, M in (mats.items() if "csr" in sections else ()):
        for half in (False, True):
            Mh = M.astype(torch.bfloat16 if half else torch.float32)
            x = torch.randn(M.num_cols, generator=g, device=dev).to(
                Mh.values.dtype)
            kw = {"lanes": Mh.csr_lanes} if lanes else {}
            lib = cs.csr_library(torch, Mh)
            if half:
                lib_call, _ = cs.bf16_library(torch, Mh, x)
            else:
                lib_call = (lambda lib=lib, x=x: lib @ x)
            case("csr_spmv_bf16" if half else "csr_spmv",
                 f"{tag} {M.num_rows}x{M.num_cols} nnz {M.nnz}",
                 lambda M=Mh, x=x, kw=kw: C.csr_spmv(
                     M.row_offsets, M.col_indices, M.values, x, **kw),
                 lambda M=Mh, x=x: C.csr_spmv_plain(
                     M.row_offsets, M.col_indices, M.values, x),
                 1, lib_call, half=half)
    return 0


if __name__ == "__main__":
    sys.exit(main())
