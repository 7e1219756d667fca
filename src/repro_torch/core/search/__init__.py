"""One search harness for the whole stack: compositional config spaces
(:class:`ConfigSpace`), partial-config action graphs
(:class:`SearchGraph`), and cost-model-guided :func:`beam_search` with
whole-frontier vectorised pricing.  The installer's budgeted grids, the
tuner's dispatch-time ``search=`` path, and the benchmarks all go
through here instead of bespoke candidate lists.
"""

from repro_torch.core.search.beam import BeamResult, beam_search, exhaustive_best
from repro_torch.core.search.graph import SearchGraph
from repro_torch.core.search.space import Axis, ConfigSpace, Gate

__all__ = [
    "Axis", "BeamResult", "ConfigSpace", "Gate", "SearchGraph",
    "beam_search", "exhaustive_best",
]
