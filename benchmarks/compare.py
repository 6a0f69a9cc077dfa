"""The comparison that decides `correct`: the program's first steps against
the reference's, by six numbers, each held to the cell's limit where it has
one. The first step is the graphed step's eager warm-up; the second and
third replay the graph the window times, and are read through the third's
gradient (grad3_gap, embed_row3_gap), the change after it and the losses.

- loss_gap: the largest |loss - ref| / |ref| over the checked steps.
- grad_gap: the worst leaf's |norm of its first gradient - ref's| over the
  larger of ref's norm of that leaf and of the median leaf.
- change_gap: the same for each leaf's change over the checked steps, of
  the leaves whose reference gradient is at least 1e-3 of the median
  leaf's (a leaf whose gradient is nought to rounding, as a key's bias is
  under softmax, moves under Adam by round-off alone).
- embed_row_gap: the same as grad_gap over the rows of the token
  embedding's first gradient, measured against the median row a token of
  the batch reaches: a row of a token the batch does not hold is 0 on both
  sides, and one token altered or left out moves its row by its whole norm.
- grad3_gap, embed_row3_gap: grad_gap and embed_row_gap of the last checked
  step's gradient, which the program's AdamW holds as its first moment less
  b1 times the one before (exact for float32 moments), against the
  reference's gradient at the state that step started from (the program's),
  so that they judge that step alone and not the trajectory before it.

A non-finite reading counts as NONFINITE.
"""

from __future__ import annotations

import math
import statistics

import torch

NONFINITE = 1e30
NUMBERS = ("loss_gap", "grad_gap", "embed_row_gap", "change_gap", "grad3_gap", "embed_row3_gap")
# A leaf whose reference gradient is under this share of the median leaf's
# is left out of change_gap.
FLAT_LEAF = 1e-3


def _finite(x: float) -> float:
    return x if math.isfinite(x) else NONFINITE


def _worst(got: dict, ref: dict, names) -> tuple[float, str]:
    floor = statistics.median(ref[n] for n in names)
    gaps = {n: _finite(abs(got[n] - ref[n]) / max(ref[n], floor, 1e-30)) for n in names}
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def _worst_row(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, str]:
    got, ref = got.double(), ref.double()
    floor = max(ref[ref > 0].median().item(), 1e-30)
    gaps = torch.nan_to_num((got - ref).abs() / torch.clamp(ref, min=floor),
                            nan=NONFINITE, posinf=NONFINITE)
    return gaps.max().item(), f"row {int(gaps.argmax())}"


def readings(got: dict, ref: dict) -> dict:
    """{number: value} and {number}_leaf (the worst leaf or row) of the
    program's observations `got` against the reference's `ref`
    (reference.train.observe's keys)."""
    out = {"loss_gap": _finite(max(abs(a - b) / abs(b) for a, b in
                                   zip(got["losses"], ref["losses"])))}
    if len(got["losses"]) != len(ref["losses"]):
        out["loss_gap"] = NONFINITE
    names = list(ref["grad_norms"])
    for key, at in (("", ""), ("3", "last_")):
        out[f"grad{key}_gap"], out[f"grad{key}_gap_leaf"] = _worst(
            got[f"{at}grad_norms"], ref[f"{at}grad_norms"], names)
        out[f"embed_row{key}_gap"], out[f"embed_row{key}_gap_leaf"] = _worst_row(
            got[f"{at}embed_rows"], ref[f"{at}embed_rows"])
    median_g = statistics.median(ref["grad_norms"].values())
    moving = [n for n in names if ref["grad_norms"][n] >= FLAT_LEAF * median_g]
    out["change_gap"], out["change_gap_leaf"] = _worst(got["change_norms"], ref["change_norms"],
                                                       moving)
    out["flat_leaves"] = [n for n in names if n not in moving]
    return out


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number compared within its limit, {number: {"value", "limit"}}).
    A limit of None leaves its number out: neither the control nor a fault
    reads it far enough above the sound runs to place a limit between them."""
    checks = {n: {"value": values[n], "limit": limits[n]} for n in NUMBERS
              if limits[n] is not None}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
