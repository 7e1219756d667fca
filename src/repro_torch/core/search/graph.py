"""Action graph over a :class:`~repro.core.search.space.ConfigSpace`.

States are partial configs — tuples of ``(axis_name, value)`` pairs in
the order the policy assigned them.  Actions refine the next unassigned
axis with one of its gate-admissible values.  A state prices as its
*canonical completion* (space defaults / first-admissible fills), so a
whole frontier can be scored with one vectorised cost-model pass even
though most of its states are partial.

The expansion ``order`` is a policy choice, independent of the space's
canonical axis order: beam search refines ``partition`` before
``n_chips`` (four informative branches before the wide chip axis), while
tie-breaking and enumeration stay in canonical order so a full-width
beam still reproduces the exhaustive argmin exactly.
"""

from __future__ import annotations

from typing import Iterable

from repro_torch.core.costmodel import GemmConfig
from repro_torch.core.search.space import ConfigSpace

__all__ = ["SearchGraph"]

State = tuple  # tuple[tuple[str, object], ...]


class SearchGraph:
    def __init__(self, space: ConfigSpace, dims=None,
                 order: Iterable[str] | None = None):
        self.space = space
        self.dims = tuple(int(x) for x in dims) if dims is not None \
            else None
        names = [ax.name for ax in space.axes]
        if order is None:
            ordered = list(names)
        else:
            ordered = [nm for nm in order if nm in names]
            ordered += [nm for nm in names if nm not in ordered]
        self.order: tuple[str, ...] = tuple(ordered)
        self._axes = {ax.name: ax for ax in space.axes}

    def initial(self) -> State:
        return ()

    def is_complete(self, state: State) -> bool:
        return len(state) == len(self.order)

    def partial(self, state: State) -> dict:
        return dict(state)

    def actions(self, state: State) -> list:
        """Admissible values for the next unassigned axis (empty when
        the state is complete or over-gated)."""
        if self.is_complete(state):
            return []
        ax = self._axes[self.order[len(state)]]
        partial = dict(state)
        out = []
        for v in ax.values:
            trial = dict(partial)
            trial[ax.name] = v
            if self.space.check(trial, self.dims):
                out.append(v)
        return out

    def apply(self, state: State, value) -> State:
        return state + ((self.order[len(state)], value),)

    def config(self, state: State) -> GemmConfig:
        """The state's canonical completion — what the cost model prices."""
        return self.space.complete(dict(state), self.dims)
