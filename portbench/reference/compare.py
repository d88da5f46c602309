"""The numbers that decide ``correct``, each a gap between the program's
reading and the reference's.

Training gaps are taken by the worst leaf: the gap between the program's
norm of a leaf and the reference's, over the larger of the reference's
norm of that leaf and of the median leaf (some gradients are all but
zero).  A leaf whose reference gradient is under a thousandth of the
median leaf's moves by round-off alone and is left out of the change.
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, List, Optional, Sequence

CHANGE_FLOOR = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep=None) -> Dict[str, float]:
    """Each leaf's gap, over the larger of its reference norm and the
    median leaf's."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in names}


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float], n: int = 6
                 ) -> list:
    """The n leaves with the widest gaps: [name, gap, program, reference]."""
    gaps = leaf_gaps(prog, ref)
    top = sorted(gaps, key=lambda k: -gaps[k])[:n]
    return [[k, gaps[k], prog[k], ref[k]] for k in top]


def relative_errors(prog: Dict[str, Any], ref: Dict[str, Any]
                    ) -> Dict[str, float]:
    """Each leaf's ||program - reference|| / ||reference||."""
    return {k: float((prog[k].double() - ref[k].double()).norm()
                     / ref[k].double().norm().clamp(min=1e-30))
            for k in ref}


def training_gaps(losses: Sequence[float], grad_norms: Dict[str, float],
                  change_norms: Dict[str, float], ref: Dict[str, Any],
                  grads: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, float]:
    """``loss_gap``: the largest relative gap of a step's loss;
    ``grad_gap``: the first gradient by the worst leaf; ``change_gap``:
    the change after the steps by the worst leaf that moved; the median
    leaf's of both; and with the program's gradients, ``grad_rel_median``,
    the median leaf's relative error of the first gradient."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                        ref["losses"]))
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    moved = {k for k, v in g.items() if v >= CHANGE_FLOOR * med}
    grad = leaf_gaps(grad_norms, g)
    change = leaf_gaps(change_norms, ref["change_norms"], moved)
    out = {"loss_gap": loss_gap,
           "grad_gap": max(grad.values()),
           "grad_gap_median": statistics.median(grad.values()),
           "change_gap": max(change.values()),
           "change_gap_median": statistics.median(change.values())}
    if grads is not None:
        out["grad_rel_median"] = statistics.median(
            relative_errors(grads, ref["grads"]).values())
        out["head_grad_err"] = head_error(grads, ref["grads"])
    return out


def head_error(prog: Dict[str, Any], ref: Dict[str, Any]) -> float:
    """||program - reference|| / ||reference|| of the first gradient of the
    output head and the final norm together: the part of the backward pass
    that runs before any block's."""
    keys = [k for k in ref if not k.startswith("layers.") and k != "embed"]
    num = sum(float((prog[k].double() - ref[k].double()).square().sum())
              for k in keys)
    den = sum(float(ref[k].double().square().sum()) for k in keys)
    return (num / max(den, 1e-300)) ** 0.5


def served_gap(ref_logits, tokens: Sequence[int], vocab: int) -> float:
    """The widest gap by which a served token's reference logit lies
    below the reference's best over the vocabulary (not its padding)."""
    lg = ref_logits[:, :vocab].double()
    best = lg.max(dim=1).values
    got = lg[range(len(tokens)), list(tokens)]
    return float((best - got).max())


def records_mismatch(got: List[tuple], expected: List[tuple]) -> int:
    """Records that differ, position by position, plus those missing or
    extra."""
    bad = sum(1 for a, b in zip(got, expected) if tuple(a) != tuple(b))
    return bad + abs(len(got) - len(expected))
