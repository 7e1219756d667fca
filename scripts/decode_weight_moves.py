#!/usr/bin/env python3
"""The weights a decode step on the production mesh gathers whole every
step, by arch: stored cut by the param specs, computed whole.

    python3 scripts/decode_weight_moves.py [--mesh single|multi]

Which weight a rank computes with in which layout is
``serve.step.forward_specs``'s rule, the one ``build_decode``'s
``forward_params`` applies.  A weight stored cut and computed whole is
all-gathered once a step.  For each arch this prints those weights
grouped by kind (the layer's block and name), their bytes a rank once
gathered (bf16, the dry run's type) and the bytes a rank receives to
gather them.  Derived from the specs and shapes alone: no tensor is
made.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

BYTES = 2   # bf16


def moves(arch: str, mesh) -> dict[str, tuple[int, int]]:
    """{kind: (bytes a rank whole, bytes a rank receives)} of the weights
    ``arch``'s decode step gathers on ``mesh`` (a ``MeshShape``)."""
    from repro_torch.configs import build_model, get_config
    from repro_torch.dist.sharding import partition_params
    from repro_torch.models.params import is_spec, tree_leaves, tree_paths
    from repro_torch.serve.step import forward_specs

    cfg = get_config(arch)
    model = build_model(cfg)
    paths = tree_paths(model.defs)
    computed = forward_specs(paths, mesh, keep_experts=True, model=model,
                             decode=True)
    stored = tree_leaves(partition_params(model, cfg, mesh), is_leaf=is_spec)
    out: dict[str, tuple[int, int]] = {}
    for path, d, spec, at in zip(paths, tree_leaves(model.defs), stored,
                                 computed):
        cut = math.prod(mesh.shape[a] for e in spec if e is not None
                        for a in ((e,) if isinstance(e, str) else e))
        if cut == 1 or at != ():
            continue
        kind = "/".join(str(p) for p in path if not isinstance(p, int)
                        and p != "layers")
        whole = math.prod(d.shape) * BYTES
        w, r = out.get(kind, (0, 0))
        out[kind] = (w + whole, r + whole - whole // cut)
    return out


def main(argv=None) -> None:
    from repro_torch.configs import ARCH_IDS
    from repro_torch.dist.sharding import MeshShape

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    args = ap.parse_args(argv)
    mesh = MeshShape({"data": 16, "model": 16} if args.mesh == "single"
                     else {"pod": 2, "data": 16, "model": 16})
    for arch in ARCH_IDS:
        m = moves(arch, mesh)
        whole = sum(w for w, _ in m.values())
        recv = sum(r for _, r in m.values())
        print(f"{arch}: {whole / 1e9:.3f} GB a rank gathered whole a step "
              f"({recv / 1e9:.3f} GB received)")
        for kind, (w, r) in sorted(m.items(), key=lambda kv: -kv[1][0]):
            print(f"  {kind}: {w / 1e9:.3f} GB ({r / 1e9:.3f} received)")


if __name__ == "__main__":
    main()
