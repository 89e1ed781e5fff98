"""Sequential statistical sampling for fault-injection campaigns.

DAVOS-style iterative statistical injection: instead of burning a fixed
``--trials`` per configuration, trials run in chunks and the configuration
stops as soon as its SDC-rate binomial confidence interval is tight enough
to support the verdict.  The math here is deliberately dependency-free
(no scipy in the image):

  * **Wilson score interval** — the default.  Closed-form, well-behaved at
    the boundary rates campaigns live at (SDC = 0/n for a working policy,
    detection = n/n), never degenerates to a zero-width interval the way
    the naive Wald interval does at p̂ ∈ {0, 1}.
  * **Clopper–Pearson** — the exact interval, computed by bisecting the
    binomial CDF (log-space pmf summation, no special functions beyond
    ``math.lgamma``).  Conservative: never *tighter* than Wilson, so a
    CP-stopped campaign never stops earlier than a Wilson-stopped one at
    the same target half-width.

``SamplingPlan`` bundles the stopping rule plus the execution knobs the
adaptive engine needs (chunk sizes, minimum sample, worker count) so one
frozen value pins a campaign's entire execution policy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np

# two-sided normal quantiles for the confidence levels campaigns use; a
# lookup (not an erfinv approximation) keeps stopping decisions bit-stable
# across platforms
_Z = {
    0.80: 1.2815515655446004,
    0.90: 1.6448536269514722,
    0.95: 1.959963984540054,
    0.98: 2.3263478740408408,
    0.99: 2.5758293035489004,
    0.995: 2.807033768343811,
}

CI_METHODS = ("wilson", "clopper-pearson")


def z_for_confidence(confidence: float) -> float:
    for level, z in _Z.items():
        if abs(confidence - level) < 1e-9:
            return z
    raise ValueError(f"unsupported confidence level {confidence!r}; "
                     f"supported: {sorted(_Z)}")


def wilson_interval(k: int, n: int, confidence: float = 0.95,
                    ) -> Tuple[float, float]:
    """Wilson score interval for ``k`` successes in ``n`` Bernoulli trials."""
    if n <= 0:
        return (0.0, 1.0)
    z = z_for_confidence(confidence)
    p = k / n
    z2 = z * z
    denom = 1.0 + z2 / n
    center = (p + z2 / (2.0 * n)) / denom
    hw = (z / denom) * math.sqrt(p * (1.0 - p) / n + z2 / (4.0 * n * n))
    # pin the boundary cases exactly: center ∓ hw leaves float dust at
    # k ∈ {0, n} (≈1e-17), which would make CI columns seed-shaped noise
    lo = 0.0 if k <= 0 else max(0.0, center - hw)
    hi = 1.0 if k >= n else min(1.0, center + hw)
    return (lo, hi)


def _binom_cdf(k: int, n: int, p: float) -> float:
    """P(X <= k) for X ~ Binomial(n, p), via log-space pmf summation."""
    if k >= n:
        return 1.0
    if p <= 0.0:
        return 1.0
    if p >= 1.0:
        return 0.0
    i = np.arange(0, k + 1, dtype=np.int64)
    log_c = np.array([math.lgamma(n + 1) - math.lgamma(int(j) + 1)
                      - math.lgamma(n - int(j) + 1) for j in i])
    log_pmf = log_c + i * math.log(p) + (n - i) * math.log1p(-p)
    m = float(log_pmf.max())
    return float(min(1.0, math.exp(m) * float(np.exp(log_pmf - m).sum())))


def _bisect(f, lo: float, hi: float, iters: int = 80) -> float:
    """Root of monotone ``f`` on [lo, hi] with f(lo) <= 0 <= f(hi)."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if f(mid) <= 0.0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def clopper_pearson_interval(k: int, n: int, confidence: float = 0.95,
                             ) -> Tuple[float, float]:
    """Exact (conservative) binomial interval by CDF bisection."""
    if n <= 0:
        return (0.0, 1.0)
    z_for_confidence(confidence)        # validate the level early
    alpha = 1.0 - confidence
    # lower bound: largest p with P(X >= k | p) <= alpha/2
    if k <= 0:
        lo = 0.0
    else:
        # P(X >= k | p) grows with p: negative below the root, as _bisect
        # expects (f(lo) <= 0 <= f(hi))
        lo = _bisect(lambda p: (1.0 - _binom_cdf(k - 1, n, p)) - (alpha / 2.0),
                     0.0, 1.0)
    # upper bound: smallest p with P(X <= k | p) <= alpha/2
    if k >= n:
        hi = 1.0
    else:
        hi = _bisect(lambda p: (alpha / 2.0) - _binom_cdf(k, n, p), 0.0, 1.0)
    return (lo, hi)


def binomial_interval(k: int, n: int, confidence: float = 0.95,
                      method: str = "wilson") -> Tuple[float, float]:
    if method == "wilson":
        return wilson_interval(k, n, confidence)
    if method == "clopper-pearson":
        return clopper_pearson_interval(k, n, confidence)
    raise ValueError(f"unknown CI method {method!r}; known: {CI_METHODS}")


def halfwidth(interval: Tuple[float, float]) -> float:
    lo, hi = interval
    return (hi - lo) / 2.0


def class_intervals(counts: Dict[str, int], trials: int,
                    confidence: float = 0.95, method: str = "wilson",
                    ) -> Dict[str, Tuple[float, float]]:
    """Binomial CI per outcome class (masked / detected_* / sdc)."""
    return {cls: binomial_interval(k, trials, confidence, method)
            for cls, k in counts.items()}


@dataclasses.dataclass(frozen=True)
class SamplingPlan:
    """How a campaign executes its trials.

    ``ci_halfwidth = 0`` is the legacy fixed-budget mode: every configuration
    runs exactly ``spec.trials`` trials.  ``ci_halfwidth > 0`` switches on
    sequential sampling: trials run in chunks and the configuration stops at
    the first chunk boundary where the SDC-rate CI half-width is at most
    ``ci_halfwidth`` (after at least ``min_trials`` trials), with
    ``spec.trials`` as the hard cap.  The stopping decision is evaluated in
    chunk order, so sharded execution — which merely computes chunks
    speculatively on other processes — stops at exactly the same boundary
    and executes exactly the same trial set as a serial run.
    """
    ci_halfwidth: float = 0.0
    confidence: float = 0.95
    ci_method: str = "wilson"
    chunk: int = 25             # host-side cases: trials per scheduling chunk
    kernel_chunk: int = 128     # vmapped cases: trials per compiled batch
    min_trials: int = 25        # adaptive floor before the CI may stop a row
    workers: int = 0            # >0: process-pool sharding for host cases

    def __post_init__(self):
        if self.ci_halfwidth < 0:
            raise ValueError("ci_halfwidth must be >= 0")
        if self.chunk < 1 or self.kernel_chunk < 1:
            raise ValueError("chunk sizes must be >= 1")
        if self.ci_method not in CI_METHODS:
            raise ValueError(f"unknown CI method {self.ci_method!r}; "
                             f"known: {CI_METHODS}")
        z_for_confidence(self.confidence)

    @property
    def adaptive(self) -> bool:
        return self.ci_halfwidth > 0

    def sdc_interval(self, sdc: int, n: int) -> Tuple[float, float]:
        return binomial_interval(sdc, n, self.confidence, self.ci_method)

    def should_stop(self, sdc: int, n: int, cap: int) -> bool:
        """Evaluate the stopping rule after ``n`` merged trials."""
        if n >= cap:
            return True
        if not self.adaptive or n < min(self.min_trials, cap):
            return False
        return halfwidth(self.sdc_interval(sdc, n)) <= self.ci_halfwidth
