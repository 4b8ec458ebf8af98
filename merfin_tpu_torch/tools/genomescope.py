"""GenomeScope2-style model fit + merfin -prob lookup-table generation
(a copy of ``merfin_tpu/tools/genomescope.py``; numpy only).

    python -m merfin_tpu_torch.tools.genomescope hist.tsv 21 out [ploidy]

Reimplements the reference's modified GenomeScope
(scripts/lookup_table/lookup.R) in Python/numpy:

  * fit a negative-binomial mixture to the k-mer multiplicity histogram
    (4-peak diploid model, lookup.R:29-57; 2-peak haploid, :65-92),
    with two starting coverages (peak and peak/2, :250-279), four
    trimming rounds with score/heterozygosity-based model selection
    (:798-904),
  * derive per-copy-number component curves (:466-469), error k-mers
    (observed - predicted, truncated at the first zero before the
    half-coverage point, :399-428),
  * emit lookup_table.txt rows "readK,prob" for multiplicity 1..5*kcov-1
    where readK = argmax copy number (0-4) and prob its posterior
    (:677-704) — the file merfin consumes via -prob
    (merfin-globals.C:21-62).

No scipy in this environment: the negative binomial uses math.lgamma and
the optimizer is a small bounded Levenberg-Marquardt (numeric Jacobian).
Fitted parameters can differ from R's nlsLM in trailing digits; the
table is a modeling artifact, not a bit-parity surface.
"""

from __future__ import annotations

import dataclasses
import math
import sys

import numpy as np

NUM_ROUNDS = 4
START_SHIFT = 5
TYPICAL_ERROR = 15
MAX_ITERATIONS = 200
SCORE_CLOSE = 0.20
SCORE_HET_FOLD_DIFFERENCE = 10

_lgamma = np.vectorize(math.lgamma, otypes=[np.float64])


def dnbinom(x: np.ndarray, size: float, mu: float) -> np.ndarray:
    """R dnbinom(x, size, mu): NB pmf by mean parameterization."""
    if size <= 0 or mu <= 0:
        return np.zeros_like(np.asarray(x, dtype=np.float64))
    x = np.asarray(x, dtype=np.float64)
    p = size / (size + mu)
    logp = (
        _lgamma(x + size) - _lgamma(size) - _lgamma(x + 1)
        + size * math.log(p) + x * math.log1p(-p)
    )
    return np.exp(logp)


def model_4peak(x, d, r, kmercov, bias, length, k):
    """Diploid 4-peak mixture (lookup.R:52-56 / 466-469 coefficients)."""
    a1 = (2 * (1 - d) * (1 - (1 - r) ** k)
          + 2 * d * (1 - (1 - r) ** k) ** 2
          + 2 * d * ((1 - r) ** k) * (1 - (1 - r) ** k))
    a2 = (1 - d) * ((1 - r) ** k) + d * (1 - (1 - r) ** k) ** 2
    a3 = 2 * d * ((1 - r) ** k) * (1 - (1 - r) ** k)
    a4 = d * (1 - r) ** (2 * k)
    comps = [
        a1 * dnbinom(x, kmercov / bias, kmercov),
        a2 * dnbinom(x, kmercov * 2 / bias, kmercov * 2),
        a3 * dnbinom(x, kmercov * 3 / bias, kmercov * 3),
        a4 * dnbinom(x, kmercov * 4 / bias, kmercov * 4),
    ]
    return length * sum(comps), comps


def model_2peak(x, d, r, kmercov, bias, length, k):
    """Haploid 2-peak mixture (lookup.R:86-88)."""
    a2 = (1 - d) * ((1 - r) ** k)
    a4 = d * (1 - r) ** (2 * k)
    comps = [
        a2 * dnbinom(x, kmercov * 2 / bias, kmercov * 2),
        a4 * dnbinom(x, kmercov * 4 / bias, kmercov * 4),
    ]
    return length * sum(comps), comps


def _lm_fit(residual_fn, p0, lower, upper, max_iter=MAX_ITERATIONS):
    """Bounded Levenberg-Marquardt with numeric Jacobian."""
    p = np.clip(np.asarray(p0, dtype=np.float64), lower, upper)
    lam = 1e-3
    r = residual_fn(p)
    cost = float(r @ r)
    n = p.size
    for _ in range(max_iter):
        jac = np.empty((r.size, n))
        for j in range(n):
            h = max(1e-8, 1e-6 * abs(p[j]))
            pj = p.copy()
            pj[j] = min(p[j] + h, upper[j])
            hh = pj[j] - p[j]
            if hh == 0:
                pj[j] = max(p[j] - h, lower[j])
                hh = pj[j] - p[j]
            jac[:, j] = (residual_fn(pj) - r) / hh if hh != 0 else 0.0
        g = jac.T @ r
        a = jac.T @ jac
        improved = False
        for _ in range(20):
            try:
                step = np.linalg.solve(a + lam * np.diag(np.maximum(np.diag(a), 1e-12)), -g)
            except np.linalg.LinAlgError:
                lam *= 10
                continue
            p_new = np.clip(p + step, lower, upper)
            r_new = residual_fn(p_new)
            c_new = float(r_new @ r_new)
            if c_new < cost:
                rel = (cost - c_new) / max(cost, 1e-300)
                p, r, cost = p_new, r_new, c_new
                lam = max(lam / 3, 1e-12)
                improved = True
                if rel < 1e-12:
                    return p, cost, True
                break
            lam *= 10
            if lam > 1e12:
                return p, cost, True
        if not improved:
            break
    return p, cost, True


@dataclasses.dataclass
class FitResult:
    d: float
    r: float
    kmercov: float
    bias: float
    length: float
    ploidy: int
    k: int
    score_all: float = math.inf

    def predict(self, x):
        fn = model_4peak if self.ploidy != 1 else model_2peak
        return fn(x, self.d, self.r, self.kmercov, self.bias, self.length, self.k)[0]

    def components(self, x):
        fn = model_4peak if self.ploidy != 1 else model_2peak
        return fn(x, self.d, self.r, self.kmercov, self.bias, self.length, self.k)[1]


def _fit_once(x, y, k, est_kmercov, est_length, ploidy) -> FitResult | None:
    fn = model_4peak if ploidy != 1 else model_2peak

    def residual(p):
        pred, _ = fn(x, p[0], p[1], p[2], p[3], p[4], k)
        return pred - y

    p0 = np.asarray([0.10, 0.001, est_kmercov, 0.5, est_length])
    lower = np.asarray([0.0, 1e-5, 0.0, 1e-12, 0.0])
    upper = np.asarray([1.0, 1.0, np.inf, np.inf, np.inf])
    try:
        p, cost, ok = _lm_fit(residual, p0, lower, upper)
    except Exception:
        return None
    if not ok or not np.isfinite(cost):
        return None
    return FitResult(p[0], p[1], p[2], p[3], p[4], ploidy, k)


def _score_model(x_full, y_full, fit: FitResult) -> float:
    """RSSE excluding sequencing errors (lookup.R:100-137), 'all' range."""
    pred = fit.predict(x_full)
    kcovfloor = int(math.floor(fit.kmercov))
    idx = np.nonzero(x_full == kcovfloor)[0]
    cutoff = int(idx[0]) if idx.size else min(len(x_full) - 1, 1)
    err = y_full[: cutoff + 1] - pred[: cutoff + 1]
    first_zero = -1
    for i in range(cutoff + 1):
        if first_zero == -1:
            if err[i] < 1.0:
                first_zero = i
        else:
            err[i] = 0
    if first_zero == -1:
        first_zero = cutoff
    resid = y_full[first_zero:] - pred[first_zero:]
    return float(np.sum(resid ** 2))


def fit_histogram(hist: np.ndarray, k: int, ploidy: int = 2,
                  log=sys.stderr) -> FitResult | None:
    """The full 4-round fitting loop (lookup.R:798-904).

    hist: [N, 2] array of (multiplicity, count), sorted by multiplicity.
    """
    hist = np.asarray(hist, dtype=np.float64)
    if hist[0, 0] == 0:
        hist = hist[1:]
    hist = hist[:-1]  # drop last (overflow) bin, lookup.R:797
    x_full, y_full = hist[:, 0], hist[:, 1]

    start = int(np.argmin(y_full[:TYPICAL_ERROR]))
    best: FitResult | None = None

    for rnd in range(NUM_ROUNDS):
        x = x_full[start:]
        y = y_full[start:]
        if x.size < 10:
            break
        numof = float(np.sum(x * y))
        est1 = float(x[np.argmax(y)])
        cands = []
        f1 = _fit_once(x, y, k, est1, numof / est1, ploidy)
        f2 = _fit_once(x, y, k, est1 / 2, numof / (est1 / 2), 2 if ploidy != 1 else 1)
        for f in (f1, f2):
            if f is not None:
                f.score_all = _score_model(x_full, y_full, f)
                cands.append(f)
        if not cands:
            start += START_SHIFT
            continue
        model = min(cands, key=lambda f: f.score_all)
        print(f"round {rnd} trimming to {start + 1} ... score {model.score_all:.4g} "
              f"kcov {model.kmercov:.2f} het {model.r:.5f}", file=log)

        if best is None:
            best = model
        else:
            pdiff = abs(model.score_all - best.score_all) / max(model.score_all, best.score_all)
            if pdiff < SCORE_CLOSE:
                if best.r * SCORE_HET_FOLD_DIFFERENCE < model.r:
                    best = model
                elif model.r * SCORE_HET_FOLD_DIFFERENCE < best.r:
                    pass
                elif model.score_all < best.score_all:
                    best = model
            elif model.score_all < best.score_all:
                best = model
        start += START_SHIFT
    return best


def lookup_table(hist: np.ndarray, fit: FitResult) -> list[tuple[int, float]]:
    """Rows (readK, prob) for multiplicity 1..5*kcov-1 (lookup.R:677-704)."""
    hist = np.asarray(hist, dtype=np.float64)
    if hist[0, 0] == 0:
        hist = hist[1:]
    hist = hist[:-1]
    x, y = hist[:, 0], hist[:, 1]

    pred = fit.predict(x)
    comps = fit.components(x)          # per-copy curves WITHOUT length
    akcov = fit.kmercov
    amlen = fit.length

    # error kmers: observed - predicted up to 2*floor(kcov), truncated at
    # the first point below 1.0 (lookup.R:399-428)
    cutoff_val = math.floor(fit.kmercov) * 2
    idx = np.nonzero(x == cutoff_val)[0]
    cut = int(idx[0]) + 1 if idx.size else len(x)
    error_kmers = np.zeros(len(x))
    error_kmers[:cut] = y[:cut] - pred[:cut]
    first_zero = -1
    for i in range(cut):
        if first_zero == -1:
            if error_kmers[i] < 1.0:
                first_zero = i
        else:
            error_kmers[i] = 0
    error_kmers = np.maximum(error_kmers, 1e-10)
    error_kmers[cut:] = 0.0

    fitted = np.stack(comps, axis=1)   # [N, ncomp]
    zero_from = int(akcov * 5)
    if zero_from < fitted.shape[0]:
        fitted[zero_from - 1:, :] = 0.0   # R 1-based index akcov*5
    fitted = np.nan_to_num(fitted)

    rows = []
    top = int(akcov * 5) - 1
    for i in range(0, min(top, len(x))):
        total = error_kmers[i] + float(np.sum(fitted[i] * amlen))
        if total <= 0:
            rows.append((0, 0.0))
            continue
        prob = np.concatenate([[error_kmers[i] / total], fitted[i] * amlen / total])
        prob = np.nan_to_num(prob)
        read_k = int(np.argmax(prob))
        rows.append((read_k, float(prob[read_k])))
    return rows


def write_lookup_table(path: str, rows: list[tuple[int, float]]) -> None:
    with open(path, "w") as f:
        for read_k, p in rows:
            f.write(f"{read_k},{p!r}\n")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        sys.stderr.write(
            "usage: genomescope.py <kmer_histogram.tsv> <k> <out_prefix> [ploidy]\n"
            "  writes <out_prefix>.lookup_table.txt (merfin -prob input)\n")
        return 1
    hist = np.loadtxt(argv[0])
    k = int(argv[1])
    out = argv[2]
    ploidy = int(argv[3]) if len(argv) > 3 else 2
    fit = fit_histogram(hist, k, ploidy)
    if fit is None:
        sys.stderr.write("model failed to converge\n")
        return 1
    print(f"kcov={fit.kmercov:.4f} het={fit.r:.6f} dup={fit.d:.4f} "
          f"bias={fit.bias:.4f} length={fit.length:.0f}")
    rows = lookup_table(hist, fit)
    write_lookup_table(f"{out}.lookup_table.txt", rows)
    print(f"wrote {out}.lookup_table.txt ({len(rows)} rows); "
          f"use with: merfin-tpu-torch -polish -prob {out}.lookup_table.txt "
          f"-peak {fit.kmercov:.3f} ...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
