"""Online tuners of the fusion threshold (counterpart of
horovod_tpu/core/autotune.py GaussianProcess, BayesianOptimization, the
knobs, ParameterManager and OnlineBucketTuner).

`GaussianProcess` and `BayesianOptimization` are the JAX package's numpy
code, line for line, so that the same samples give the same proposals.
`ParameterManager` (HOROVOD_AUTOTUNE) scores windows of
`autotune_steps_per_sample` gradient reductions in bytes a second,
discards `autotune_warmup_samples` windows and the first step after each
change, proposes the next setting by expected improvement, and after
`autotune_bayes_opt_max_samples` samples re-measures the best one
against the starting setting and freezes the faster.
`OnlineBucketTuner` (HOROVOD_BUCKET_AUTOTUNE) folds per-bucket (bytes,
seconds) samples into log2 size classes and re-points the threshold at
the fastest class every `bucket_autotune_interval` steps, with the
reference's guards.

In a world of more than one rank, rank 0 decides and broadcasts the
decision (`optim/functions.py broadcast_object`), and every rank counts
sample windows and decision windows per `update()` call, so the
broadcast is a collective that every rank issues at the same step. The
tuners write `Config` fields; optim/optimizer.py DistributedOptimizer
re-plans its buckets between steps when the threshold moves.

The ParameterManager marks each sample boundary on the timeline
(`mark_cycle`, drawn under HOROVOD_TIMELINE_MARK_CYCLES), as the JAX
package's does. Left out: the JAX tuners' metrics (ROADMAP A13), the
cache-capacity knob (see `default_knobs`), and OnlineLayoutTuner,
which tunes the layout pass (A7).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np


class GaussianProcess:
    """RBF-kernel regression with a Cholesky solve."""

    def __init__(self, length_scale: float = 1.0, noise: float = 0.8,
                 sigma_f: float = 1.0):
        self.l = length_scale
        self.noise = noise
        self.sigma_f = sigma_f
        self._x: Optional[np.ndarray] = None
        self._y: Optional[np.ndarray] = None
        self._alpha: Optional[np.ndarray] = None
        self._L: Optional[np.ndarray] = None

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return self.sigma_f ** 2 * np.exp(-0.5 * d2 / self.l ** 2)

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        self._x = np.atleast_2d(x)
        self._y = np.asarray(y, np.float64)
        k = self._kernel(self._x, self._x) + \
            self.noise ** 2 * np.eye(len(self._x))
        self._L = np.linalg.cholesky(k)
        self._alpha = np.linalg.solve(
            self._L.T, np.linalg.solve(self._L, self._y))

    def predict(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        x = np.atleast_2d(x)
        ks = self._kernel(x, self._x)
        mu = ks @ self._alpha
        v = np.linalg.solve(self._L, ks.T)
        var = np.clip(self.sigma_f ** 2 - (v ** 2).sum(0), 1e-12, None)
        return mu, np.sqrt(var)


class BayesianOptimization:
    """Expected-improvement acquisition over [0, 1]^dims."""

    def __init__(self, dims: int, noise: float = 0.8, seed: int = 0):
        self.dims = dims
        self.gp = GaussianProcess(length_scale=0.3, noise=noise)
        self._rng = np.random.default_rng(seed)
        self.xs: List[np.ndarray] = []
        self.ys: List[float] = []

    def register(self, x: np.ndarray, y: float) -> None:
        self.xs.append(np.asarray(x, np.float64))
        self.ys.append(float(y))

    def next_sample(self) -> np.ndarray:
        if len(self.xs) < 2:
            return self._rng.uniform(size=self.dims)
        # Scores are standardised before the fit: raw bytes a second
        # (~1e9) against the prior's sigma_f = 1 would underflow EI.
        ys = np.asarray(self.ys, np.float64)
        mu0, sd0 = ys.mean(), ys.std()
        yn = (ys - mu0) / (sd0 if sd0 > 0 else 1.0)
        ymax = yn.max()
        self.gp.fit(np.stack(self.xs), yn)
        cand = self._rng.uniform(size=(256, self.dims))
        mu, sd = self.gp.predict(cand)
        z = (mu - ymax - 0.01) / sd
        from math import erf, sqrt
        cdf = 0.5 * (1 + np.vectorize(erf)(z / sqrt(2)))
        pdf = np.exp(-0.5 * z ** 2) / np.sqrt(2 * np.pi)
        ei = (mu - ymax - 0.01) * cdf + sd * pdf
        return cand[int(np.argmax(ei))]


_MB = 1024 * 1024


class _Knob:
    """One coordinate of the search space, read from and written to a
    Config field."""

    name: str

    def get(self, cfg):
        raise NotImplementedError

    def set(self, cfg, value) -> bool:
        """Apply; returns True if the config changed."""
        raise NotImplementedError

    def to_unit(self, value) -> float:
        raise NotImplementedError

    def from_unit(self, u: float):
        raise NotImplementedError


class _Log2Knob(_Knob):
    """Integer knob on a log2 scale over [lo, hi]."""

    def __init__(self, name: str, attr: str, lo: float, hi: float):
        self.name, self.attr = name, attr
        self.lo, self.hi = math.log2(lo), math.log2(hi)

    def get(self, cfg):
        return int(getattr(cfg, self.attr))

    def set(self, cfg, value) -> bool:
        changed = int(value) != int(getattr(cfg, self.attr))
        setattr(cfg, self.attr, int(value))
        return changed

    def to_unit(self, value) -> float:
        u = (math.log2(max(value, 1)) - self.lo) / (self.hi - self.lo)
        return min(max(u, 0.0), 1.0)

    def from_unit(self, u: float):
        return int(2 ** (self.lo + float(u) * (self.hi - self.lo)))


class _BoolKnob(_Knob):
    def __init__(self, name: str, attr: str):
        self.name, self.attr = name, attr

    def get(self, cfg):
        return bool(getattr(cfg, self.attr))

    def set(self, cfg, value) -> bool:
        changed = bool(value) != bool(getattr(cfg, self.attr))
        setattr(cfg, self.attr, bool(value))
        return changed

    def to_unit(self, value) -> float:
        return 0.75 if value else 0.25

    def from_unit(self, u: float):
        return float(u) >= 0.5


def default_knobs(cfg=None) -> List[_Knob]:
    """The fusion threshold over [1 MiB, min(256 MiB, the bucket cap)]
    (a threshold above the cap plans the same buckets), plus
    hierarchical allreduce where HOROVOD_TPU_MESH_SHAPE gives a split
    for it to act on. The JAX package also tunes its compiled-executable
    cache capacity; the port compiles no programs and has no such
    cache, so it has no cache knob."""
    hi = 256 * _MB
    if cfg is not None and getattr(cfg, "bucket_cap_bytes", 0) > 0:
        hi = min(hi, max(int(cfg.bucket_cap_bytes), 2 * _MB))
    knobs: List[_Knob] = [
        _Log2Knob("fusion_threshold", "fusion_threshold_bytes",
                  1 * _MB, hi),
    ]
    if cfg is not None and getattr(cfg, "mesh_shape", ""):
        knobs.append(_BoolKnob("hierarchical_allreduce",
                               "hierarchical_allreduce"))
    return knobs


@dataclasses.dataclass
class _Sample:
    x: np.ndarray
    bytes: float = 0.0
    seconds: float = 0.0
    steps: int = 0
    # Steps to discard before scoring: the first step after a change
    # re-plans the buckets.
    skip: int = 0


def _world_size() -> int:
    from horovod_tpu_torch.core import topology
    return topology.size() if topology.is_initialized() else 1


def _rank() -> int:
    from horovod_tpu_torch.core import topology
    return topology.rank()


def _broadcast(obj):
    from horovod_tpu_torch.optim.functions import broadcast_object
    return broadcast_object(obj, root_rank=0)


class ParameterManager:
    """Online knob tuner: warm-up discard, per-sample scoring, GP
    proposal, and a freeze playoff between the GP's best and the start.

    Driven from the gradient reduction:
        pm.record(total_bytes, seconds)   # once per reduction
        if pm.update():                   # a knob changed: re-plan
            ...
    """

    def __init__(self, config, knobs=None):
        self.cfg = config
        self.enabled = bool(config.autotune)
        self.warmup_remaining = config.autotune_warmup_samples
        self.steps_per_sample = config.autotune_steps_per_sample
        self.max_samples = config.autotune_bayes_opt_max_samples
        self.knobs = knobs if knobs is not None else default_knobs(config)
        self.bayes = BayesianOptimization(
            dims=len(self.knobs),
            noise=config.autotune_gaussian_process_noise)
        self._current = _Sample(x=self._to_unit())
        # The raw starting values, for the playoff (a start outside a
        # knob's range clamps in unit space).
        self._default_vals = {k.name: k.get(config) for k in self.knobs}
        self._x0 = self._to_unit()
        self._samples_done = 0
        self._frozen = False
        self._phase = "tune"  # tune -> playoff_best -> playoff_default
        self._playoff_x: Optional[np.ndarray] = None
        self._playoff_best_score: float = 0.0
        self.playoff_result: Optional[dict] = None
        # (knob values, score) of every scored window, on the deciding
        # rank.
        self._log_rows: List[Tuple] = []

    def _to_unit(self) -> np.ndarray:
        return np.asarray([k.to_unit(k.get(self.cfg)) for k in self.knobs])

    def _decode(self, x: np.ndarray) -> dict:
        return {k.name: k.from_unit(x[i])
                for i, k in enumerate(self.knobs)}

    def record(self, nbytes: float, seconds: float) -> None:
        if not self.enabled or self._frozen:
            return
        s = self._current
        if s.skip > 0:
            s.skip -= 1
            return
        s.bytes += nbytes
        s.seconds += seconds
        s.steps += 1

    def update(self) -> bool:
        """Advance the tuner; True when a knob changed (the caller
        re-plans). In a world of more than one rank, rank 0 decides and
        every rank applies its decision."""
        if not self.enabled or self._frozen:
            return False
        s = self._current
        if s.steps < self.steps_per_sample:
            return False
        # A sample boundary is this design's "cycle" (the reference
        # marks its background loop's cycles).
        from horovod_tpu_torch.core import topology
        tl = topology.timeline()
        if tl is not None:
            tl.mark_cycle()
        score = s.bytes / max(s.seconds, 1e-12)  # bytes a second
        if self.warmup_remaining > 0:
            self.warmup_remaining -= 1
            self._current = _Sample(x=s.x)
            return False
        if _world_size() > 1:
            new_x, self._frozen = self._coordinate_multiprocess(s.x, score)
        else:
            new_x, self._frozen = self._decide(s.x, score)
        if isinstance(new_x, str):  # "default": the raw start values
            changed = self._apply_raw(self._default_vals)
            cur_x = self._x0
        else:
            changed = self._apply(new_x)
            cur_x = np.asarray(new_x)
        self._current = _Sample(x=cur_x, skip=1 if changed else 0)
        self._maybe_log()
        return changed

    def _decide(self, x: np.ndarray, score: float):
        """One decision on the deciding rank; returns (new_x, frozen).
        After `max_samples` the GP's best is re-measured for one window,
        then the start for one window, and the faster is frozen."""
        if self._phase == "playoff_best":
            self._playoff_best_score = score
            self._log_rows.append((self._decode(x), score))
            self._phase = "playoff_default"
            return "default", False
        if self._phase == "playoff_default":
            self._log_rows.append((dict(self._default_vals), score))
            tuned_wins = self._playoff_best_score > score
            self.playoff_result = {
                "tuned": self._decode(self._playoff_x),
                "tuned_bytes_per_sec": self._playoff_best_score,
                "default": dict(self._default_vals),
                "default_bytes_per_sec": score,
                "winner": "tuned" if tuned_wins else "default",
            }
            return (self._playoff_x if tuned_wins else "default"), True
        self.bayes.register(x, score)
        self._log_rows.append((self._decode(x), score))
        self._samples_done += 1
        if self._samples_done >= self.max_samples:
            self._playoff_x = np.asarray(
                self.bayes.xs[int(np.argmax(self.bayes.ys))])
            self._phase = "playoff_best"
            return self._playoff_x, False
        return self.bayes.next_sample(), False

    def _coordinate_multiprocess(self, x: np.ndarray, score: float):
        """Rank 0 decides on its own timings and broadcasts; the others
        follow."""
        if _rank() == 0:
            new_x, frozen = self._decide(x, score)
            decision = (new_x if isinstance(new_x, str)
                        else np.asarray(new_x).tolist(), frozen)
        else:
            decision = None
        new_x_list, frozen = _broadcast(decision)
        return (new_x_list if isinstance(new_x_list, str)
                else np.asarray(new_x_list)), frozen

    def _apply(self, x: np.ndarray) -> bool:
        return self._apply_raw(self._decode(np.asarray(x)))

    def _apply_raw(self, vals: dict) -> bool:
        changed = False
        for k in self.knobs:
            changed |= k.set(self.cfg, vals[k.name])
        return changed

    def _maybe_log(self) -> None:
        """Append the last scored window to HOROVOD_AUTOTUNE_LOG."""
        if not self.cfg.autotune_log or not self._log_rows:
            return
        try:
            with open(self.cfg.autotune_log, "a") as f:
                vals, score = self._log_rows[-1]
                row = "\t".join(f"{k}={v}" for k, v in vals.items())
                f.write(f"{row}\t{score:.3e}\t"
                        f"{'frozen' if self._frozen else 'tuning'}\n")
        except OSError:
            pass

    @property
    def frozen(self) -> bool:
        return self._frozen

    @property
    def samples(self) -> List[Tuple[dict, float]]:
        """(knob values, bytes a second) of each scored window, in order
        (the deciding rank's)."""
        return list(self._log_rows)

    def frozen_choice(self) -> dict:
        """The knob values applied now (the frozen choice once
        `frozen`)."""
        return {k.name: k.get(self.cfg) for k in self.knobs}


class OnlineBucketTuner:
    """Move `fusion_threshold_bytes` to the bucket size class that moves
    the most bytes a second, online.

    Guards, the reference's: proposals are powers of two within
    [256 KiB, HOROVOD_BUCKET_CAP (or 64 MiB)]; at most
    `bucket_autotune_max_adjustments` changes, then it freezes; it also
    freezes after two no-change decisions in a row or after
    `max_windows` decision windows; a class needs `_MIN_SAMPLES` samples
    to count, and must beat the current class by `_HYSTERESIS`. Rank 0
    decides and broadcasts at the same `update()` call on every rank.
    """

    _MIN_T = 256 * 1024
    _MIN_SAMPLES = 8
    _HYSTERESIS = 0.10

    def __init__(self, config):
        self.cfg = config
        self.enabled = bool(config.bucket_autotune)
        self.interval = max(int(config.bucket_autotune_interval), 1)
        self.max_adjustments = max(
            int(config.bucket_autotune_max_adjustments), 0)
        cap = config.bucket_cap_bytes if config.bucket_cap_bytes > 0 \
            else 64 * _MB
        self._max_t = max(int(cap), self._MIN_T)
        self._classes: dict = {}  # log2(nbytes) -> [bytes, secs, count]
        self._calls = 0
        self._windows = 0
        self.max_windows = 2 * self.max_adjustments + 4
        self.adjustments = 0
        self._no_change = 0
        self._frozen = not self.enabled
        self.history: List[int] = []
        # (step, new threshold or None, freeze) of every decision window.
        self.decisions: List[Tuple[int, Optional[int], bool]] = []

    @property
    def frozen(self) -> bool:
        return self._frozen

    def record_bucket(self, nbytes: float, seconds: float) -> None:
        """One bucket's wire bytes and launch-to-completion seconds."""
        if self._frozen or seconds <= 0 or nbytes <= 0:
            return
        c = int(math.log2(max(nbytes, 1)))
        acc = self._classes.setdefault(c, [0.0, 0.0, 0])
        acc[0] += nbytes
        acc[1] += seconds
        acc[2] += 1

    def _rates(self) -> dict:
        return {c: acc[0] / acc[1] for c, acc in self._classes.items()
                if acc[2] >= self._MIN_SAMPLES and acc[1] > 0}

    def _decide(self):
        """Rank 0's decision: (new threshold or None, freeze)."""
        if self.adjustments >= self.max_adjustments \
                or self._windows > self.max_windows:
            return None, True
        rates = self._rates()
        if not rates:
            return None, False
        best_c = max(rates, key=lambda c: rates[c])
        proposal = min(max(2 ** (best_c + 1), self._MIN_T), self._max_t)
        eff = max(min(self.cfg.fusion_threshold_bytes, self._max_t),
                  self._MIN_T)
        # Buckets planned under threshold t fill to just under t: class
        # floor(log2(t - 1)).
        cur_c = int(math.log2(max(eff - 1, 1)))
        cur_rate = rates.get(cur_c, 0.0)
        if best_c == cur_c or proposal == eff or \
                (cur_rate > 0 and rates[best_c] <
                 cur_rate * (1.0 + self._HYSTERESIS)):
            self._no_change += 1
            return None, self._no_change >= 2
        self._no_change = 0
        return proposal, self.adjustments + 1 >= self.max_adjustments

    def update(self) -> bool:
        """Advance the tuner; call once per optimizer step on every rank.
        True when the threshold changed at this step."""
        if self._frozen:
            return False
        self._calls += 1
        if self._calls % self.interval:
            return False
        self._windows += 1
        if _world_size() > 1:
            decision = self._decide() if _rank() == 0 else None
            new_t, freeze = _broadcast(decision)
        else:
            new_t, freeze = self._decide()
        changed = False
        if new_t is not None and \
                int(new_t) != int(self.cfg.fusion_threshold_bytes):
            self.cfg.fusion_threshold_bytes = int(new_t)
            self.adjustments += 1
            self.history.append(int(new_t))
            changed = True
        if freeze:
            self._frozen = True
        self.decisions.append((self._calls, None if new_t is None
                               else int(new_t), bool(freeze)))
        return changed
