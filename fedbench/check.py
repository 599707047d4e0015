"""The comparison that decides ``correct``: the program's first rounds
against the plain reference's.

A round is the training step of a federation: the server's optimizer
(FedAvg) takes the clients' mean as its update.  Five numbers are
compared, each as the worst case of a relative gap:

* ``loss``: every block step's loss in the first ``loss_rounds`` checked
  rounds (all of them unless the cell's file says fewer), keyed by
  (round, client, step): ``|program - reference| / |reference|``.
* ``step1``: per leaf, the norm of the state's change in the first
  round (the first update as the server's optimizer gets it), the gap
  between the program's norm and the reference's, over the reference's
  norm of that leaf or of the median leaf, whichever is larger; the
  worst leaf's gap.
* ``change``: the same for the change over all the checked rounds;
  leaves whose first-round change in the reference is under a
  thousandth of the median leaf's (zero up to rounding: an untied
  embedding, a key bias under softmax) are left out.
* ``step1_diff``, ``change_diff``: as ``step1`` and ``change``, with the
  norm of the difference of the two sides' changes in the place of the
  gap of their norms, so that a change of the right size in a wrong
  direction (a gradient transposed or of the wrong sign) fails too.

Each of these four is also taken at the median leaf in the place of the
worst one, as ``<name>_median``.  A cell compares the numbers that its
``workloads/<cell>.json`` gives a limit, ``loss`` always.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Optional, Tuple

from fedbench import trees

LEAF_NAMES = ("step1", "change", "step1_diff", "change_diff")
NAMES = ("loss",) + LEAF_NAMES + tuple(f"{n}_median" for n in LEAF_NAMES)
QUIET_LEAF = 1e-3


def _ratios(num: Dict[str, float], ref: Dict[str, float], paths):
    """Each leaf's ``num`` over the reference's norm of that leaf or of
    the median leaf, whichever is larger."""
    med = statistics.median(ref[p] for p in paths)
    return [num[p] / max(ref[p], med, 1e-30) for p in paths]


def diffs(prog: dict, ref: dict) -> Dict[int, Dict[str, float]]:
    """Per round and leaf, the norm of the difference of the two sides'
    changes."""
    return {rd: trees.diff_norms(prog["deltas"][rd], d)
            for rd, d in ref["deltas"].items()}


def numbers(prog: dict, ref: dict, first: int, last: int,
            loss_rounds: Optional[int] = None,
            diff: Optional[Dict[int, Dict[str, float]]] = None
            ) -> Dict[str, float]:
    """Every number of ``NAMES`` from two sides' readings: ``losses``
    ``{(round, client, step): float}``, ``norms`` ``{round: {path:
    norm}}`` and ``deltas`` ``{round: {path: tensor}}`` (the change
    itself) for the ``first`` and ``last`` checked round; the losses of
    rounds below ``first + loss_rounds`` (all, if None) count.  ``diff``
    is :func:`diffs` of the two sides, worked out here if not given."""
    diff = diffs(prog, ref) if diff is None else diff
    lp, lr = prog["losses"], ref["losses"]
    end = last + 1 if loss_rounds is None else first + loss_rounds
    keys = [k for k in lr if k[0] < end]
    if set(lp) != set(lr) or not keys:
        loss = math.inf
    else:
        loss = max(abs(lp[k] - lr[k]) / max(abs(lr[k]), 1e-30)
                   for k in keys)
    out = {"loss": loss}
    n1r = ref["norms"][first]
    med = statistics.median(n1r.values())
    everyone = sorted(n1r)
    moving = [p for p in everyone if n1r[p] >= QUIET_LEAF * med]
    for name, rd, paths in (("step1", first, everyone),
                            ("change", last, moving)):
        np_, nr = prog["norms"][rd], ref["norms"][rd]
        if set(np_) != set(nr):
            gaps = dgaps = [math.inf]
        else:
            gaps = _ratios({p: abs(np_[p] - nr[p]) for p in paths}, nr,
                           paths)
            dgaps = _ratios(diff[rd], nr, paths)
        for key, g in ((name, gaps), (f"{name}_diff", dgaps)):
            out[key] = max(g)
            out[f"{key}_median"] = statistics.median(g)
    # a NaN anywhere reads as the worst case
    return {k: (math.inf if math.isnan(v) else v) for k, v in out.items()}


def judge(nums: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """(every number within its limit, ``{name: {value, limit}}``); a
    number without a limit in the cell's file is not compared."""
    table = {k: {"value": nums[k], "limit": limits[k]} for k in NAMES
             if k in limits}
    return all(v["value"] <= v["limit"] for v in table.values()), table
