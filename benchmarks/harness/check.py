"""The numbers that decide ``correct``: the program's outputs against the
plain reference's, over every kept request, each held to the limit in
``checks/<workload>.json``. What each number counts is the request
kind's (``counts`` in ``kinds/<kind>.py``)."""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple


def tolerances(spec: Dict) -> Dict[str, float]:
    return {k: v.get("tolerance", 0.0) for k, v in spec["numbers"].items()}


def numbers(counts: Callable, pairs: Iterable[Tuple[Dict, Dict]],
            spec: Dict) -> Dict[str, float]:
    """Each number of ``counts`` (a kind's counter) over all (program,
    reference) pairs: a share as the summed count over the summed base, a
    largest value as the largest."""
    tol = tolerances(spec)
    acc: Dict[str, list] = {}
    for prog, ref in pairs:
        for k, (how, *v) in counts(prog, ref, tol).items():
            if how == "share":
                a = acc.setdefault(k, ["share", 0.0, 0.0])
                a[1] += v[0]
                a[2] += v[1]
            else:
                a = acc.setdefault(k, ["max", 0.0])
                a[1] = max(a[1], v[0])
    return {k: ((a[1] / a[2] if a[2] else 0.0) if a[0] == "share" else a[1])
            for k, a in acc.items()}


def judge(values: Dict[str, float], spec: Dict) -> Tuple[bool, Dict]:
    """(correct, {name: {"value", "limit"}}) for the numbers ``spec``
    holds to a limit; a missing value fails."""
    report, ok = {}, True
    for name, s in spec["numbers"].items():
        v = values.get(name)
        report[name] = {"value": v, "limit": s["limit"]}
        if v is None or not v <= s["limit"]:
            ok = False
    return ok, report
