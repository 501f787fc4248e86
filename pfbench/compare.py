"""The comparison that decides ``correct``: the numbers a cell compares with
the plain reference; those named in ``limits/<cell>.json`` are each held
to their limit there, the others are printed beside them.

Training (the first steps of the timed path against the reference's), for
each leaf (a parameter, or a recipe's extra leaf such as an activation
range) and over the larger of that leaf's reference norm and the median
leaf's:

* ``grad_gap``: |norm of the program's first gradient (its SGD momentum
  after one step) - the reference's|, ``change_gap`` the same of each
  leaf's change over the checked steps; ``.median_leaf`` the median leaf's
  reading, bare the worst leaf's;
* ``grad_diff.last_kernel`` and ``change_diff.last_kernel``: the norm of
  the difference of the two tensors, of the classifier's kernel;
* ``loss_gap``: the widest |loss - reference loss| / |reference loss| over
  the checked steps.

Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of the changes.

Serving (requests of the timed window drawn from the seed):

* ``logit_gap``: over the sampled requests' rows, the widest
  |logits - reference logits| / |reference logits| (L2 norms of a row);
* ``site_gap``: of one sampled request, the widest over the int8 sites of
  |site output - reference site output| / |reference site output| (L2
  norms of the whole output; each side's site reads its own side's
  input); ``site_gap.local`` the same with the reference's site alone
  reading the program's input to it, so that a fault at one site shows
  undamped by the layers before it.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Tuple

NEGLIGIBLE = 1e-3  # a leaf whose reference gradient is under this share of the median's


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              leaves: Optional[List[str]] = None) -> Dict[str, float]:
    """{leaf: |program norm - reference norm| / max(reference norm, median
    reference norm)}; a leaf the program lacks reads 0."""
    leaves = sorted(reference) if leaves is None else leaves
    median = statistics.median(reference[k] for k in leaves)
    out = {}
    for k in leaves:
        p = program.get(k, 0.0)
        out[k] = abs(p - reference[k]) / max(reference[k], median, 1e-30) \
            if math.isfinite(p) else math.inf
    return out


def leaf_diffs(program, reference, norms: Dict[str, float], leaves: List[str],
               among: Optional[List[str]] = None) -> Dict[str, float]:
    """{leaf: |program - reference| / max(reference norm, median reference
    norm)} of each of `leaves`, the tensors' difference in L2 norm; the
    median over the leaves `among` (default: all of `norms`)."""
    median = statistics.median(norms[k] for k in (among or norms))
    out = {}
    for k in leaves:
        d = float((program[k].double() - reference[k].double()).norm()) if k in program \
            else norms[k]
        out[k] = d / max(norms[k], median, 1e-30) if math.isfinite(d) else math.inf
    return out


def worst_leaf(gaps: Dict[str, float]) -> Tuple[float, str]:
    at = max(gaps, key=lambda k: gaps[k])
    return gaps[at], at


def median_leaf(gaps: Dict[str, float]) -> Tuple[float, str]:
    ordered = sorted(gaps, key=lambda k: gaps[k])
    at = ordered[(len(ordered) - 1) // 2]
    return gaps[at], at


def train_numbers(program: Dict, reference: Dict,
                  last_kernel: Optional[str] = None) -> Dict[str, Tuple[float, str]]:
    """{number: (value, where)} of program and reference readings, each a
    dict of 'losses' (a list), 'grad1' and 'change' ({leaf: norm})."""
    losses = [abs(p - r) / abs(r) if math.isfinite(p) else math.inf
              for p, r in zip(program['losses'], reference['losses'])]
    loss_gap = max(losses)
    grads = reference['grad1']
    median = statistics.median(grads.values())
    moved = [k for k in reference['change']
             if k not in grads or grads[k] >= NEGLIGIBLE * median]
    grad = leaf_gaps(program['grad1'], grads)
    change = leaf_gaps(program['change'], reference['change'], moved)
    last = last_kernel or sorted(k for k in grads if k.endswith('.kernel'))[-1]
    grad_diff = leaf_diffs(program['grad1_t'], reference['grad1_t'], grads, [last])
    change_diff = leaf_diffs(program['change_t'], reference['change_t'], reference['change'],
                             [last], moved)
    return {
        'loss_gap': (loss_gap, 'step %d' % (losses.index(loss_gap) + 1)),
        'grad_gap': worst_leaf(grad),
        'change_gap': worst_leaf(change),
        'grad_gap.median_leaf': median_leaf(grad),
        'change_gap.median_leaf': median_leaf(change),
        'grad_diff.last_kernel': (grad_diff[last], last),
        'change_diff.last_kernel': (change_diff[last], last),
    }


def last_kernel(cfg: Dict) -> str:
    """The state-dict name of the configuration's last layer's kernel."""
    return cfg['layers'][-1]['p'].replace('/', '.') + '.kernel'


def row_gap(program, reference) -> float:
    """The widest relative L2 gap of a row of logits (torch tensors [N, C])."""
    diff = (program.double() - reference.double()).norm(dim=1)
    return float((diff / reference.double().norm(dim=1).clamp_min(1e-30)).max())


def tensor_gap(program, reference) -> float:
    """|program - reference| / |reference| in L2 over whole tensors."""
    diff = float((program.double() - reference.double()).norm())
    return diff / max(float(reference.double().norm()), 1e-30)


def judge(numbers: Dict[str, Tuple[float, str]], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(every limited number within its limit, {number: {'value', 'limit',
    'at'}} of those).  A limited number that is missing or not finite
    fails; the others are printed beside them and decide nothing."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value, at = numbers.get(name, (math.inf, 'missing'))
        ok = ok and math.isfinite(value) and value <= limit
        checks[name] = {'value': value, 'limit': limit, 'at': at}
    return ok, checks
