"""The plain reference of -polish with a -prob table (merfin-globals.C,
varMer.C), for a sample of a VCF's clusters: the clusters, windows,
paths and selection of ``reference/polish.py``, with each path scored as
merfin scores it under the table:

* readK and prob of a raw read value v as getK gives them
  (merfin-globals.C:66-98): 0 for v = 0, 1 under the peak, else C
  round(v / peak), and for 1 <= v <= the table's rows the row's copy
  number and probability (prob 1 elsewhere);
* an invalid window keeps the prob of the path's last valid window, 1
  before the first (the local that getK alone writes, varMer.C:60,84);
* a window's delta is |readK - asmK| * prob minus |readK - asmK'| *
  prob, asmK' = asmK + 1 where the window overlaps a variant the path
  takes: three roundings, never a fused multiply-add;
* totdK adds a path's deltas one window at a time from 0.0, in path
  order, as getTotdK does (varMer.C:648-659): one column of a block of
  paths at a time.

``dtype`` float32 gives the same computation one precision below the
configuration's float64.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.polish import _CODE, _U32
from portbench.reference.values import const, db_values, to_device


def parse_table(text: str) -> tuple[list[int], list[float]]:
    """(copy numbers, probabilities) of a -prob file's ``readK,prob``
    lines; other lines are skipped (merfin-globals.C:21-62)."""
    ck, cp = [], []
    for line in text.splitlines():
        w = line.rstrip("\r").split(",")
        if len(w) != 2:
            continue
        try:
            k, p = int(w[0]), float(w[1])
        except ValueError:
            continue
        ck.append(k)
        cp.append(p)
    return ck, cp


class ProbScorer:
    """numM and totdK of paths against DB arrays (sorted keys < 2^63,
    values) under a -prob table, on ``device``."""

    def __init__(self, k: int, peak: float, read_keys, read_vals, asm_keys,
                 asm_vals, table: str, device, dtype=torch.float64):
        self.k, self.peak, self.device, self.dtype = k, peak, device, dtype
        self.rk = to_device(read_keys, device)
        self.rv = to_device(read_vals, device)
        self.ak = to_device(asm_keys, device)
        self.av = to_device(asm_vals, device)
        ck, cp = parse_table(table)
        self.ck = torch.tensor(ck, dtype=dtype, device=device)
        self.cp = torch.tensor(cp, dtype=dtype, device=device)

    @classmethod
    def of_world(cls, world, table: str, device, dtype=torch.float64):
        return cls(world.k, world.peak, world.read_keys, world.read_vals,
                   world.asm_keys, world.asm_vals, table, device, dtype)

    def get_k(self, v: torch.Tensor):
        """(readK, prob) of raw read values."""
        x = v.to(self.dtype)
        r = torch.floor(x / const(self.peak, x) + 0.5)
        r = torch.where(v == 0, torch.zeros_like(x),
                        torch.where(x < self.peak, torch.ones_like(x), r))
        n = self.ck.numel()
        p = torch.ones_like(x)
        if n:
            row = (v - 1).clamp(0, n - 1)
            hit = (v >= 1) & (v <= n)
            r = torch.where(hit, self.ck[row], r)
            p = torch.where(hit, self.cp[row], p)
        return r, p

    def score(self, paths, rows: int = 1 << 15):
        """(numM list, totdK list) of traverse_paths' paths, in blocks
        of ``rows`` paths."""
        num_m, totdk = [], []
        for lo in range(0, len(paths), rows):
            m, t = self._block(paths[lo: lo + rows])
            num_m += m
            totdk += t
        return num_m, totdk

    def _block(self, paths):
        k, dev, dt = self.k, self.device, self.dtype
        lens = np.asarray([len(p[0]) for p in paths], np.int64)
        L = int(lens.max())
        codes = np.full((len(paths), L), 4, np.uint8)
        for i, p in enumerate(paths):
            codes[i, : lens[i]] = _CODE[np.frombuffer(p[0].encode(), np.uint8)]
        W = max(1, L - k + 1)
        c = torch.from_numpy(codes).to(dev)
        good = c < 4
        ci = torch.where(good, c, torch.zeros_like(c)).to(torch.int64)
        P = len(paths)
        fmer = torch.zeros((P, W), dtype=torch.int64, device=dev)
        rmer = torch.zeros_like(fmer)
        ok = torch.ones((P, W), dtype=torch.bool, device=dev)
        for j in range(k):
            cj = ci[:, j: j + W]
            fmer = (fmer << 2) | cj
            rmer |= (3 - cj) << (2 * j)
            ok &= good[:, j: j + W]
        q = torch.minimum(fmer, rmer)
        idx = torch.arange(W, device=dev)
        n_win = torch.from_numpy(lens - k + 1).to(dev)
        in_range = idx[None, :] < n_win[:, None]
        zero = torch.zeros((), dtype=dt, device=dev)
        r_all, p_all = self.get_k(db_values(self.rk, self.rv, q))
        r = torch.where(ok, r_all, zero)
        a = torch.where(ok, db_values(self.ak, self.av, q).to(dt), zero)
        # the stale prob: the path's last valid window's, 1 before any
        last = torch.cummax(torch.where(ok, idx[None, :].expand(P, W), -1),
                            dim=1).values
        p = torch.where(last >= 0, torch.gather(p_all, 1, last.clamp(min=0)),
                        torch.ones_like(p_all))
        num_m = ((r == 0) & in_range).sum(1)
        # asmK + 1 where the window overlaps a variant the path takes
        # (varMer.C:108, uint32 arithmetic for the window's start)
        V = len(paths[0][1])
        gp = torch.tensor([p_[1] for p_ in paths], device=dev).reshape(P, V)
        ip = torch.tensor([p_[2] for p_ in paths], device=dev).reshape(P, V)
        lp = torch.tensor([p_[3] for p_ in paths], device=dev).reshape(P, V)
        lo = (ip + 1 - k) % _U32
        hi = ip + lp + k
        cover = torch.zeros((P, W), dtype=torch.bool, device=dev)
        for v in range(V):
            cover |= (gp[:, v: v + 1] > 0) \
                & (idx[None, :] >= lo[:, v: v + 1]) \
                & (idx[None, :] < hi[:, v: v + 1])
        o_delta = (r - a).abs() * p
        n_delta = (r - (a + cover.to(dt))).abs() * p
        dk = o_delta - n_delta
        totdk = torch.zeros(P, dtype=dt, device=dev)
        for j in range(W):            # getTotdK: one window at a time
            totdk = torch.where(in_range[:, j], totdk + dk[:, j], totdk)
        return num_m.cpu().tolist(), totdk.double().cpu().tolist()
