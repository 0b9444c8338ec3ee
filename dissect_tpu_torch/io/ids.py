"""ID-set algebra — intersection / template ordering / difference.

Parity: auxiliar.h:47-94 (intersectionStringVectors, orderVectorAsTemplate,
differenceBetweenTwoVectors).  Ordering is load-bearing throughout the
reference (outputs follow GRM order, reml.cpp:344-374), so these helpers
preserve it explicitly.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence


def intersection_keeping_order(*id_lists: Sequence[str]) -> List[str]:
    """Intersection of several ID lists, ordered as the FIRST list.

    Parity: intersectionStringVectors (auxiliar.h:47-60).
    """
    if not id_lists:
        return []
    common = set(id_lists[0])
    for ids in id_lists[1:]:
        common &= set(ids)
    return [i for i in id_lists[0] if i in common]


def order_as_template(ids: Iterable[str], template: Sequence[str]) -> List[str]:
    """Reorder `ids` to follow `template`'s order (members only).

    Parity: orderVectorAsTemplate (auxiliar.h:61-76).
    """
    members = set(ids)
    return [t for t in template if t in members]


def difference(ids: Sequence[str], remove: Iterable[str]) -> List[str]:
    """ids minus remove, keeping ids order.

    Parity: differenceBetweenTwoVectors (auxiliar.h:77-94).
    """
    removed = set(remove)
    return [i for i in ids if i not in removed]


def indices_of(ids: Sequence[str], universe: Sequence[str]) -> List[int]:
    """Positions of each id inside `universe` (raises on absentees)."""
    index = {k: i for i, k in enumerate(universe)}
    return [index[i] for i in ids]
