"""Per-path f64 sums in path order: the fused scorer's totdK on its f64
branch, bit for bit merfin's getTotdK (varMer.C:648-659).

``path_sums(values, b_start, b_end)`` returns, for each path i, the sum
of ``values[b_start[i]:b_end[i]]`` added one value at a time from 0.0.
A CUDA tensor launches the hand-written kernel (``csrc/path_sum.cu``);
a CPU tensor runs the plain PyTorch version, which adds the same values
in the same order one column of the paths at a time.  There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from merfin_tpu_torch.ops import _build

_VP = ctypes.c_void_p


class PathSumKernel(_build.Kernel):
    """ctypes wrapper of ``csrc/path_sum.cu:merfin_path_sum``."""

    name = "path_sum"
    lib = "path_sum"
    symbol = "merfin_path_sum"
    source = "merfin_tpu_torch/csrc/path_sum.cu"
    replaces = "merfin_tpu/variants/device_score.py:_boundary_reduce (f64)"
    argtypes = [_VP, _VP, _VP, ctypes.c_longlong, _VP, _VP]

    def __call__(self, values, b_start, b_end):
        self.check(values, (values, torch.float64), (b_start, torch.int64),
                   (b_end, torch.int64))
        P = b_start.shape[0]
        if b_end.shape[0] != P:
            raise ValueError("path_sum: b_start and b_end must match")
        out = torch.empty(P, dtype=torch.float64, device=values.device)
        if P:
            self.launch(values.data_ptr(), b_start.data_ptr(),
                        b_end.data_ptr(), P, out.data_ptr(),
                        _build.raw_stream(values.device))
        return out


path_sum_kernel = PathSumKernel()


def path_sums_plain(values, b_start, b_end):
    """Plain PyTorch version: column j adds each path's j-th value to
    the paths that have one, so every path is summed in order."""
    lens = (b_end - b_start).clamp(min=0)
    out = torch.zeros(b_start.shape[0], dtype=torch.float64,
                      device=values.device)
    if values.numel() == 0 or lens.numel() == 0:
        return out
    last = values.numel() - 1
    for j in range(int(lens.max())):
        idx = (b_start + j).clamp(max=last)
        out = torch.where(lens > j, out + values[idx], out)
    return out


def path_sums(values, b_start, b_end):
    """f64 [P] in-order sums of ``values`` (f64) over the int64 ranges
    [b_start, b_end)."""
    if values.is_cuda:
        return path_sum_kernel(values.contiguous(), b_start.contiguous(),
                               b_end.contiguous())
    return path_sums_plain(values, b_start, b_end)
