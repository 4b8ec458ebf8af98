"""Run configuration of the torch port (a copy of ``merfin_tpu.config``'s
``MerfinConfig``; the device comes from ``merfin_tpu_torch.device``)."""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class MerfinConfig:
    """Mirrors the reference CLI parameter set (merfin.C:80-155).

    Attributes map 1:1 onto ``merfinGlobal`` fields
    (merfin-globals.H:132-244).
    """

    # inputs
    seq_name: str | None = None          # -sequence
    seq_db_name: str | None = None       # -seqmers
    read_db_name: str | None = None      # -readmers
    vcf_name: str | None = None          # -vcf
    out_name: str | None = None          # -output
    prob_table: str | None = None        # -prob

    # k* parameters
    peak: float = 0.0                    # -peak
    min_v: int = 0                       # -min  (read DB only, merfin-globals.C:136)
    max_v: int = 2**64 - 1               # -max  (read DB only)

    # run-time parameters
    threads: int = 0                     # -threads (0 = auto)
    max_memory_gb: float = 0.0           # -memory  (0 = auto)

    # variant-mode parameters
    nosplit: bool = False                # -nosplit
    comb: int = 15                       # -comb   (merfin-globals.H:241)
    debug: bool = False                  # -debug
    resume: bool = False                 # -resume (extension: sequence-level checkpoint/restart)
    mesh: str | None = None              # -mesh DxT (extension: shard tables over a device mesh)
    sortjoin: bool | None = None         # -sortjoin/-nosortjoin (default: auto on accelerators)
    devscore: bool | None = None         # -devscore/-nodevscore (None = auto:
                                         #  fused device scoring for the numM-only
                                         #  modes, host scoring for -polish/-debug)
    skip_missing: bool = False           # -skipMissing

    # report type: one of hist|completeness|dump|filter|polish|better|strict|loose
    report_type: str | None = None

    def __post_init__(self) -> None:
        if self.max_memory_gb <= 0:
            self.max_memory_gb = _default_memory_gb()


def _default_memory_gb() -> float:
    """Default memory budget, like getMaxMemoryAllowed() (merfin-globals.H:232)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) / 1024.0 / 1024.0
    except OSError:
        pass
    return float(os.environ.get("MERFIN_TPU_MEMORY_GB", 16.0))
