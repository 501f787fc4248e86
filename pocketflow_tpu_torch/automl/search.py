"""AutoML outer loop: GP, TPE or random search over flag values (a copy of
pocketflow_tpu/automl/search.py, logic unchanged).

A trial is ``objective_fn(flag_dict) -> float`` run in-process under
``FLAGS.scope(**flag_dict)``: no jobs, proposal files or log scraping.  The
GP is numpy (RBF kernel + expected improvement); ``algo='TPE'`` is a
Parzen-estimator search (good/bad split, l/g ratio with a uniform prior
mix); ``algo='random'`` is plain random search.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core.metrics import get_logger

log = get_logger()


@dataclasses.dataclass
class ParamSpec:
    """One search dimension (automl.yaml param_conf entry)."""
    name: str
    ptype: str          # 'FLOAT' | 'INT' | 'LOG10'
    min: float
    max: float

    def sample(self, rng: np.random.Generator) -> float:
        if self.ptype == 'LOG10':
            value = 10 ** rng.uniform(math.log10(self.min), math.log10(self.max))
        else:
            value = rng.uniform(self.min, self.max)
        return int(round(value)) if self.ptype == 'INT' else float(value)

    def to_unit(self, value: float) -> float:
        if self.ptype == 'LOG10':
            lo, hi = math.log10(self.min), math.log10(self.max)
            return (math.log10(max(value, 1e-12)) - lo) / (hi - lo)
        return (value - self.min) / (self.max - self.min)

    def from_unit(self, u: float) -> float:
        u = min(1.0, max(0.0, u))
        if self.ptype == 'LOG10':
            lo, hi = math.log10(self.min), math.log10(self.max)
            value = 10 ** (lo + u * (hi - lo))
        else:
            value = self.min + u * (self.max - self.min)
        return int(round(value)) if self.ptype == 'INT' else float(value)


class RandomSearch:
    def __init__(self, specs: Sequence[ParamSpec], seed: int = 0):
        self.specs = list(specs)
        self.rng = np.random.default_rng(seed)

    def propose(self) -> Dict[str, float]:
        return {s.name: s.sample(self.rng) for s in self.specs}

    def update(self, proposal: Dict[str, float], objective: float):
        pass


class GPSearch(RandomSearch):
    """Gaussian-process search with expected improvement (algo_type GP)."""

    def __init__(self, specs: Sequence[ParamSpec], seed: int = 0,
                 nb_warmup: int = 8, nb_candidates: int = 256,
                 length_scale: float = 0.25, noise: float = 1e-4):
        super().__init__(specs, seed)
        self.nb_warmup = nb_warmup
        self.nb_candidates = nb_candidates
        self.length_scale = length_scale
        self.noise = noise
        self.X: List[np.ndarray] = []
        self.y: List[float] = []

    def _kernel(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / self.length_scale ** 2)

    def propose(self) -> Dict[str, float]:
        if len(self.y) < self.nb_warmup:
            return super().propose()
        X = np.asarray(self.X)
        y = np.asarray(self.y)
        y_mean, y_std = y.mean(), y.std() + 1e-9
        yn = (y - y_mean) / y_std
        K = self._kernel(X, X) + self.noise * np.eye(len(X))
        K_inv = np.linalg.inv(K)
        cands = np.stack([
            np.asarray([s.to_unit(s.sample(self.rng)) for s in self.specs])
            for _ in range(self.nb_candidates)])
        Ks = self._kernel(cands, X)
        mu = Ks @ K_inv @ yn
        var = np.maximum(1.0 - np.einsum('ij,jk,ik->i', Ks, K_inv, Ks), 1e-9)
        sigma = np.sqrt(var)
        best = yn.max()
        z = (mu - best) / sigma
        ei = sigma * (z * _norm_cdf(z) + _norm_pdf(z))
        u = cands[int(np.argmax(ei))]
        return {s.name: s.from_unit(u[i]) for i, s in enumerate(self.specs)}

    def update(self, proposal: Dict[str, float], objective: float):
        self.X.append(np.asarray([s.to_unit(proposal[s.name])
                                  for s in self.specs]))
        self.y.append(float(objective))


class TPESearch(GPSearch):
    """Tree-structured Parzen estimator (the reference AutoML's other
    algo_type, SURVEY §1 L8 / automl.yaml).

    Classic Bergstra et al. 2011: split observed trials at the gamma
    quantile of the objective into good (l) / bad (g) sets, model each with
    a per-dimension Parzen (Gaussian-kernel) density in unit space, and
    propose the candidate maximizing l(x)/g(x) among samples drawn from l.
    """

    def __init__(self, specs: Sequence[ParamSpec], seed: int = 0,
                 nb_warmup: int = 8, nb_candidates: int = 64,
                 gamma: float = 0.25):
        super().__init__(specs, seed, nb_warmup=nb_warmup,
                         nb_candidates=nb_candidates)
        self.gamma = gamma

    @staticmethod
    def _log_parzen(cands: np.ndarray, pts: np.ndarray,
                    bw: np.ndarray) -> np.ndarray:
        # mean of per-point Gaussian kernels, log-ed, per candidate, MIXED
        # with a uniform prior over the unit cube (Bergstra's prior
        # component): without it the l/g ratio entrenches the current best
        # cluster and the search locks in
        d = (cands[:, None, :] - pts[None, :, :]) / bw
        logk = -0.5 * d ** 2 - np.log(bw * math.sqrt(2 * math.pi))
        per_pt = logk.sum(-1)  # independent dims -> product of kernels
        m = per_pt.max(axis=1, keepdims=True)
        log_kde = (m + np.log(np.exp(per_pt - m).mean(axis=1,
                                                      keepdims=True)))[:, 0]
        # density = 0.75 * KDE + 0.25 * uniform(=1 on the unit cube)
        return np.logaddexp(math.log(0.75) + log_kde, math.log(0.25))

    def propose(self) -> Dict[str, float]:
        if len(self.y) < self.nb_warmup:
            return RandomSearch.propose(self)
        X = np.asarray(self.X)
        order = np.argsort(np.asarray(self.y))[::-1]  # maximize
        nb_good = max(2, int(math.ceil(self.gamma * len(order))))
        good, bad = X[order[:nb_good]], X[order[nb_good:]]
        if len(bad) < 2:
            return RandomSearch.propose(self)
        # Scott-style bandwidths with a WIDE floor: tight clusters of
        # near-duplicate good points otherwise collapse the kernel width and
        # lock the search onto the incumbent (measured on the quadratic
        # benchmark: floor 0.2 -> worst-seed -0.017 vs -0.098 at 0.03)
        bw_good = np.maximum(good.std(0) * len(good) ** -0.2, 0.2)
        bw_bad = np.maximum(bad.std(0) * len(bad) ** -0.2, 0.2)
        centers = good[self.rng.integers(0, len(good), self.nb_candidates)]
        cands = np.clip(centers + self.rng.normal(
            0.0, bw_good, centers.shape), 0.0, 1.0)
        # keep a uniform exploration slice so early bad clusters can't trap
        # the search (the l/g ratio still ranks these candidates)
        nb_uniform = max(1, self.nb_candidates // 4)
        cands[:nb_uniform] = self.rng.uniform(
            0.0, 1.0, (nb_uniform, cands.shape[1]))
        score = (self._log_parzen(cands, good, bw_good)
                 - self._log_parzen(cands, bad, bw_bad))
        u = cands[int(np.argmax(score))]
        return {s.name: s.from_unit(u[i]) for i, s in enumerate(self.specs)}


def _norm_pdf(z):
    return np.exp(-0.5 * z ** 2) / math.sqrt(2 * math.pi)


def _norm_cdf(z):
    return 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2)))


def run_automl(objective_fn: Callable[[Dict[str, float]], float],
               specs: Sequence[ParamSpec], nb_trials: int = 100,
               algo: str = 'GP', seed: int = 0,
               constraint_fn: Optional[Callable[[Dict[str, float]],
                                                Dict[str, float]]] = None
               ) -> Tuple[Dict[str, float], float, List]:
    """Run the outer loop; returns (best_params, best_objective, history).

    `objective_fn` runs one trial (e.g. a learner train+eval under
    FLAGS.scope(**params)) and returns the objective (higher = better) —
    the analogue of parse_results.py's `object_value`.  `constraint_fn` can
    repair proposals (cvt_hparam_file.py's iter_ratio_beg < iter_ratio_end
    fix-up).
    """
    searchers = {'GP': GPSearch, 'TPE': TPESearch, 'RANDOM': RandomSearch}
    if algo.upper() not in searchers:
        raise ValueError("unrecognized AutoML algo %r (choose 'GP' | 'TPE' "
                         "| 'random')" % algo)
    searcher = searchers[algo.upper()](specs, seed)
    best_params, best_obj, history = None, -np.inf, []
    for idx in range(nb_trials):
        proposal = searcher.propose()
        if constraint_fn is not None:
            proposal = constraint_fn(proposal)
        with FLAGS.scope(**proposal):
            objective = float(objective_fn(proposal))
        searcher.update(proposal, objective)
        history.append((proposal, objective))
        if objective > best_obj:
            best_params, best_obj = dict(proposal), objective
        log.info('trial #%d: obj=%.4f (best=%.4f) params=%s',
                 idx, objective, best_obj, proposal)
    return best_params, best_obj, history


def ws_constraint(proposal: Dict[str, float]) -> Dict[str, float]:
    """cvt_hparam_file.py's repair (reference :41): the proposed 'end' is a
    FRACTION of the remaining [beg, 1] interval —
    ``end <- beg + end * (1 - beg)`` unconditionally.  (A conditional swap
    would collapse distinct proposals into one config and change the search
    geometry the GP/TPE models see.)"""
    if 'ws_iter_ratio_beg' in proposal and 'ws_iter_ratio_end' in proposal:
        beg = proposal['ws_iter_ratio_beg']
        end = beg + proposal['ws_iter_ratio_end'] * (1.0 - beg)
        proposal = {**proposal, 'ws_iter_ratio_end': end}
    return proposal


# the reference's default WS search space (automl.yaml param_conf)
WS_SEARCH_SPACE = [
    ParamSpec('ws_prune_ratio_exp', 'FLOAT', 1.0, 5.0),
    ParamSpec('ws_iter_ratio_beg', 'FLOAT', 0.0, 0.9),
    ParamSpec('ws_iter_ratio_end', 'FLOAT', 0.0, 1.0),
    ParamSpec('ws_mask_update_step', 'LOG10', 50, 2000),
]
