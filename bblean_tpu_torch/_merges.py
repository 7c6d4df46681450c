r"""Merge-acceptance criteria for BitBirch clustering (host side).

All six built-in criteria of the reference (``bblean/_merges.py:9-16``) are
provided with identical decision semantics, exposed both as the classic
callable-object API (used by the exact engine) and, in
``bblean_tpu_torch.ops.merges``, as vectorized device predicates for the batched
device engine.

Decision rules (``t`` = threshold, ``isim``/``rc`` = diameter/radius cohesion
of a candidate merged cluster-feature):

- ``diameter``:            accept iff ``isim(new) >= t``
- ``radius``:              accept iff ``rc(new) >= t``
- ``tolerance-diameter``:  accept iff ``isim(new) >= t`` and (``old_n == 1`` or
  ``isim(new) >= isim(old) - tol(old_n)``) with the adaptive decay
  ``tol(n) = max(alpha * (exp(-decay * n) - exp(-decay * n_max)), 0)``
- ``tolerance-radius``:    same with the radius-complement cohesion
- ``tolerance-legacy``:    diameter screen, then for single-fp nominees a
  growth check ``(isim(new)*new_n - isim(old)*(old_n-1))/2 >= isim(old) - tol``
- ``never-merge``:         always reject (forces singleton leaves)
"""

from __future__ import annotations

import numpy as np
from numpy.typing import NDArray

from bblean_tpu_torch.similarity import jt_isim_from_sum, jt_isim_radius_compl_from_sum

__all__ = ["MergeAcceptFunction", "get_merge_accept_fn", "BUILTIN_MERGES"]

BUILTIN_MERGES = [
    "radius",
    "diameter",
    "tolerance-diameter",
    "tolerance-radius",
    "tolerance-legacy",
    "never-merge",
]


class MergeAcceptFunction:
    r"""Base class for merge-acceptance predicates.

    Called with the candidate merged linear sum / count plus the component
    cluster features; returns True to commit the merge.
    """

    name: str = ""

    def __call__(
        self,
        threshold: float,
        new_ls: NDArray[np.integer],
        new_n: int,
        old_ls: NDArray[np.integer],
        nom_ls: NDArray[np.integer],
        old_n: int,
        nom_n: int,
    ) -> bool:
        raise NotImplementedError("Must be implemented by subclasses")

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}()"


class RadiusMerge(MergeAcceptFunction):
    name = "radius"

    def __call__(self, threshold, new_ls, new_n, old_ls, nom_ls, old_n, nom_n) -> bool:
        return jt_isim_radius_compl_from_sum(new_ls, new_n) >= threshold


class DiameterMerge(MergeAcceptFunction):
    name = "diameter"

    def __call__(self, threshold, new_ls, new_n, old_ls, nom_ls, old_n, nom_n) -> bool:
        return jt_isim_from_sum(new_ls, new_n) >= threshold


class ToleranceDiameterMerge(MergeAcceptFunction):
    r"""Diameter criterion with a size-adaptive cohesion-regression tolerance.

    Small established clusters tolerate more cohesion regression than large
    ones: ``tol(n) = max(tolerance * (exp(-decay * n) - exp(-decay * n_max)),
    0)``, zero beyond ``n_max``.
    """

    name = "tolerance-diameter"

    def __init__(
        self,
        tolerance: float = 0.05,
        n_max: int = 1000,
        decay: float = 1e-3,
        adaptive: bool = True,
    ) -> None:
        self.tolerance = tolerance
        self.decay = decay
        self.offset = np.exp(-decay * n_max)
        if not adaptive:
            self.decay = 0.0
            self.offset = 0.0

    def _cohesion(self, ls: NDArray[np.integer], n: int) -> float:
        return jt_isim_from_sum(ls, n)

    def __call__(self, threshold, new_ls, new_n, old_ls, nom_ls, old_n, nom_n) -> bool:
        new_c = self._cohesion(new_ls, new_n)
        if new_c < threshold:
            return False
        if old_n == 1:
            # Cohesion of a single fp is undefined: accept unconditionally
            return True
        old_c = self._cohesion(old_ls, old_n)
        tol = max(self.tolerance * (np.exp(-self.decay * old_n) - self.offset), 0.0)
        return new_c >= old_c - tol

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({self.tolerance})"


class ToleranceRadiusMerge(ToleranceDiameterMerge):
    name = "tolerance-radius"

    def _cohesion(self, ls: NDArray[np.integer], n: int) -> float:
        return jt_isim_radius_compl_from_sum(ls, n)


class NeverMerge(ToleranceDiameterMerge):
    name = "never-merge"

    def __call__(self, threshold, new_ls, new_n, old_ls, nom_ls, old_n, nom_n) -> bool:
        return False

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}()"


class ToleranceMerge(MergeAcceptFunction):
    name = "tolerance-legacy"

    def __init__(self, tolerance: float = 0.05) -> None:
        self.tolerance = tolerance

    def __call__(self, threshold, new_ls, new_n, old_ls, nom_ls, old_n, nom_n) -> bool:
        new_dc = jt_isim_from_sum(new_ls, new_n)
        if new_dc < threshold:
            return False
        if old_n == 1 or nom_n != 1:
            return True
        # Here new_n == old_n + 1 is guaranteed (nominee is a single fp)
        old_dc = jt_isim_from_sum(old_ls, old_n)
        return (new_dc * new_n - old_dc * (old_n - 1)) / 2 >= old_dc - self.tolerance

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({self.tolerance})"


_FACTORY = {
    "radius": lambda tol: RadiusMerge(),
    "diameter": lambda tol: DiameterMerge(),
    "tolerance-legacy": lambda tol: ToleranceMerge(tol),
    "tolerance-diameter": lambda tol: ToleranceDiameterMerge(tol),
    "tolerance-radius": lambda tol: ToleranceRadiusMerge(tol),
    "never-merge": lambda tol: NeverMerge(tol),
}


def get_merge_accept_fn(
    merge_criterion: str, tolerance: float = 0.05
) -> MergeAcceptFunction:
    r"""Build a merge-acceptance callable from a builtin criterion name."""
    try:
        return _FACTORY[merge_criterion](tolerance)
    except KeyError:
        raise ValueError(
            f"Unknown merge criterion {merge_criterion}."
            f" Valid criteria are: {'|'.join(BUILTIN_MERGES)}"
        ) from None
