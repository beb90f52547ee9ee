"""Classical interpolation (the port of D2 and `_truncate` of
amgx_tpu/amg/classical/interpolators.py), on the operator's device.

D2 is the extended+i distance-two interpolation (De Sterck, Falgout,
Nolting, Yang 2008):

    w_ij = -(1/D_i) [ a_ij 1{j in C^_i}
                      + sum_{k in F_i^s} a_ik abar_kj / d_ik ]
    d_ik = sum_{l in C^_i + {i}} abar_kl
    D_i  = a_ii + sum_{n weak, n not in C^_i} a_in
                + sum_{k in F_i^s} a_ik abar_ki / d_ik

with C^_i the strong C neighbours of i plus the strong C neighbours of
its strong F neighbours, and abar the couplings opposite in sign to the
diagonal. It follows the JAX package's device formulation
(`_generate_jnp`) step by step: COO expansions of the two-hop triples,
membership by binary search over sorted keys, and every sum an ordered
segment sum in the same entry order, so P -- and above all the ties
`_truncate` breaks by magnitude -- comes out the same on the CPU, on the
card and in the JAX package. D1 and MULTIPASS are not ported.
"""
from __future__ import annotations

import torch

from ... import registry
from ...matrix import CsrMatrix
from ...ops.segment import segment_sum
from ...ops.spgemm import csr_multiply, expand


def coarse_index(cf_map):
    """(coarse id per point, -1 at F points; number of C points)."""
    is_c = cf_map == 1
    cidx = torch.cumsum(is_c.to(torch.int64), 0) - 1
    nc = int(is_c.sum())
    return torch.where(is_c, cidx, torch.full_like(cidx, -1)), nc


def _keys(A: CsrMatrix, n: int) -> torch.Tensor:
    rows, cols, _ = A.coo()
    return rows * n + cols.long()


def _member(keys, ri, cj, n):
    """Is (ri, cj) in the sorted key set?"""
    key = ri.long() * n + cj.long()
    if keys.numel() == 0:
        return torch.zeros(key.shape, dtype=torch.bool, device=key.device)
    pos = torch.searchsorted(keys, key).clamp(max=keys.numel() - 1)
    return keys[pos] == key


class Interpolator:
    def __init__(self, cfg, scope):
        self.cfg = cfg
        self.scope = scope
        self.trunc_factor = float(cfg.get("interp_truncation_factor", scope))
        self.max_elements = int(cfg.get("interp_max_elements", scope))

    def generate(self, A: CsrMatrix, cf_map, strong) -> CsrMatrix:
        raise NotImplementedError


@registry.interpolators.register("D2")
class Distance2Interpolator(Interpolator):
    def generate(self, A: CsrMatrix, cf_map, strong) -> CsrMatrix:
        n = A.num_rows
        dev = A.device
        rows, cols, vals = A.coo()
        cols = cols.long()
        zero = torch.zeros((), dtype=vals.dtype, device=dev)
        diag = A.diagonal()
        sgn = torch.sign(torch.where(diag == 0, torch.ones_like(diag), diag))
        offd = rows != cols
        neg = offd & (vals * sgn[rows] < 0)          # abar's pattern
        is_c = cf_map == 1
        cidx, nc = coarse_index(cf_map)
        strong_c = strong & is_c[cols]
        strong_f = strong & ~is_c[cols] & offd

        F = A.compact(strong_f)                      # i -> k
        Abar = A.compact(neg)                        # k -> m
        Sc = A.compact(strong_c, torch.ones_like(vals))
        H = csr_multiply(CsrMatrix(F.row_offsets, F.col_indices,
                                   torch.ones_like(F.values), n, n), Sc)
        keys_sc, keys_h = _keys(Sc, n), _keys(H, n)

        def member(ri, cj):
            return _member(keys_sc, ri, cj, n) | _member(keys_h, ri, cj, n)

        # two-hop triples i -k-> m, grouped by F entry (i, k)
        t_i, t_m, src_f, src_b = expand(F.row_offsets, F.col_indices,
                                        Abar.row_offsets, Abar.col_indices)
        t_aik = F.values[src_f]
        t_abar = Abar.values[src_b]
        keep = member(t_i, t_m) | (t_m == t_i)
        denom = segment_sum(torch.where(keep, t_abar, zero), src_f, F.nnz)
        bad = denom == 0                             # k distributes nowhere
        dsafe = torch.where(bad, torch.ones_like(denom), denom)
        contrib = t_aik * t_abar / dsafe[src_f]
        contrib = torch.where(bad[src_f], zero, contrib)

        # interpolatory entries: triples landing on C points of C^_i
        m_entry = keep & is_c[t_m] & (t_m != t_i)
        in_chat = member(rows, cols)
        dmask = offd & is_c[cols] & in_chat
        # D_i: weak lumping + the "+i" feedback + collapsed strong F
        fb = segment_sum(torch.where(keep & (t_m == t_i), contrib, zero),
                         t_i, n)
        lump = segment_sum(torch.where(offd & ~in_chat & ~strong_f, vals,
                                       zero), rows, n)
        f_rows, _, _ = F.coo()
        bad_f = segment_sum(torch.where(bad, F.values, zero), f_rows, n)
        D = diag + lump + fb + bad_f

        all_rows = torch.cat([rows[dmask], t_i[m_entry]])
        all_cols = torch.cat([cols[dmask], t_m[m_entry]])
        all_vals = torch.cat([vals[dmask], contrib[m_entry]])
        f_row = (cf_map == 0)[all_rows]
        d_all = D[all_rows]
        w = -all_vals / torch.where(d_all == 0, torch.ones_like(d_all),
                                    d_all)
        c_rows = torch.nonzero(is_c)[:, 0]
        P = CsrMatrix.from_coo(
            torch.cat([all_rows[f_row], c_rows]),
            torch.cat([cidx[all_cols[f_row]], cidx[c_rows]]),
            torch.cat([w[f_row], torch.ones(nc, dtype=vals.dtype,
                                            device=dev)]), n, nc)
        return truncate(P, self.trunc_factor, self.max_elements)


def truncate(P: CsrMatrix, factor: float, max_elements: int) -> CsrMatrix:
    """Drop small entries (below factor * the row's largest |w|, when
    factor <= 1) and keep at most max_elements per row (the largest |w|,
    the earlier column on a tie), rescaling each row to keep its sum
    (truncate.cu semantics; the JAX package's `_truncate`)."""
    if factor > 1.0 and max_elements <= 0:
        return P
    rows, _, vals = P.coo()
    n = P.num_rows
    absv = vals.abs()
    keep = torch.ones_like(vals, dtype=torch.bool)
    if factor <= 1.0:
        rmax = torch.zeros(n, dtype=vals.dtype, device=vals.device) \
            .scatter_reduce_(0, rows, absv, "amax", include_self=True)
        keep &= absv >= factor * rmax[rows]
    if max_elements > 0:
        # rank by (row, -|w|) with two stable sorts, cap the rank in row
        order1 = torch.argsort(-absv, stable=True)
        order2 = torch.argsort(rows[order1], stable=True)
        ordn = order1[order2]
        within = torch.arange(vals.shape[0], device=vals.device) \
            - P.row_offsets.long()[rows[ordn]]
        keep[ordn] = keep[ordn] & (within < max_elements)
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    rowsum = segment_sum(vals, rows, n)
    keptsum = segment_sum(torch.where(keep, vals, zero), rows, n)
    one = torch.ones_like(keptsum)
    scale = torch.where(keptsum == 0, one,
                        rowsum / torch.where(keptsum == 0, one, keptsum))
    return P.compact(keep, vals * scale[rows])


def _unported(name):
    class _Unported(Interpolator):
        def generate(self, A, cf_map, strong):
            raise NotImplementedError(
                f"interpolator={name} is not ported yet (D2 is; see "
                f"ROADMAP.md)")
    return _Unported


for _name in ("D1", "MULTIPASS"):
    registry.interpolators.register(_name)(_unported(_name))
