"""Workload profiling entry point: recorded mixes -> profile -> install.

Folds the per-cell ``dispatch`` blocks that
``repro_torch.launch.dryrun`` writes under ``results/dryrun_torch``
(and/or serve profiles written by
``repro_torch.launch.serve --profile-out``) into one merged
:class:`~repro_torch.core.workload.WorkloadProfile`, writes it out, and
optionally runs a mix-weighted ADSALA install driven by it:

    # 1. record a serving profile
    PYTHONPATH=src python -m repro_torch.launch.serve --scale smoke \
        --profile-out results/serve_profile.json
    # 2. fold the recorded mixes into a profile and install against it,
    #    timing the port's kernels on the card (--backend simulated
    #    installs on the CPU against the analytic model instead)
    PYTHONPATH=src python -m repro_torch.launch.profile \
        --profile results/serve_profile.json --install \
        --artifact results/adsala_artifact_workload

Cells are merged proportionally to their recorded flop volume — an arch
that dispatches 10x the contraction flops pulls the install budget 10x
harder toward its shapes.  The port's ``--backend measured``, the
default, is :class:`~repro_torch.core.timing.MeasuredCUDABackend`: the
port's own GEMM and flash kernels timed on the card, as the reference's
``MeasuredCPUBackend`` timed blocked BLAS-3 on its host.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from repro_torch.core import InstallConfig, SimulatedBackend, install
from repro_torch.core.costmodel import ROUTINES
from repro_torch.core.workload import WorkloadProfile


def profiles_from_dryrun(dryrun_dir: str, *, arch: str | None = None,
                         shape: str | None = None,
                         mesh: str | None = None, by: str = "flops"
                         ) -> list[WorkloadProfile]:
    """One profile per ok dry-run cell JSON (optionally filtered)."""
    out: list[WorkloadProfile] = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            cell = json.load(f)
        if cell.get("status") != "ok" or "dispatch" not in cell:
            continue
        if arch is not None and cell.get("arch") != arch:
            continue
        if shape is not None and cell.get("shape") != shape:
            continue
        if mesh is not None and cell.get("mesh") != mesh:
            continue
        out.append(WorkloadProfile.from_dispatch_block(
            cell["dispatch"], by=by,
            source={"kind": "dryrun", "arch": cell.get("arch"),
                    "shape": cell.get("shape"),
                    "mesh": cell.get("mesh"), "path": path}))
    return out


def build_profile(args: argparse.Namespace) -> WorkloadProfile:
    profiles: list[WorkloadProfile] = []
    if args.dryrun_dir:
        profiles += profiles_from_dryrun(
            args.dryrun_dir, arch=args.arch, shape=args.shape,
            mesh=args.mesh, by=args.by)
    for path in args.profile or []:
        profiles.append(WorkloadProfile.load(path))
    if not profiles:
        sys.exit(f"[profile] no dispatch blocks under "
                 f"{args.dryrun_dir!r} and no --profile files; run "
                 "repro_torch.launch.dryrun (or serve --profile-out) "
                 "first")
    if len(profiles) == 1:
        return profiles[0]
    return WorkloadProfile.merge(profiles)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="fold recorded dispatch mixes into a WorkloadProfile "
                    "and (optionally) run a mix-weighted install")
    ap.add_argument("--dryrun-dir", default="results/dryrun_torch",
                    help="directory of repro_torch.launch.dryrun cell "
                         "JSONs")
    ap.add_argument("--profile", action="append", default=None,
                    help="extra WorkloadProfile JSON(s) to merge in "
                         "(e.g. from serve --profile-out); repeatable")
    ap.add_argument("--arch", default=None,
                    help="only fold cells of this arch")
    ap.add_argument("--shape", default=None,
                    help="only fold cells of this shape (e.g. "
                         "decode_32k for a decode-serving profile)")
    ap.add_argument("--mesh", default=None, choices=["single", "multi"],
                    help="only fold cells on this mesh")
    ap.add_argument("--by", default="flops",
                    choices=["flops", "events"],
                    help="dispatch-volume weighting of the profile")
    ap.add_argument("--out", default="results/workload_profile.json")
    ap.add_argument("--install", action="store_true",
                    help="run a mix-weighted install driven by the "
                         "profile (--backend picks the timing backend)")
    ap.add_argument("--artifact", default="results/adsala_artifact_workload")
    ap.add_argument("--registry", default=None,
                    help="install into this per-arch registry root "
                         "instead of --artifact: the cell is this "
                         "machine's hardware fingerprint and the "
                         "commit is atomic (tmp/COMMIT/.prev)")
    ap.add_argument("--backend", default="measured",
                    choices=["measured", "simulated"],
                    help="timing backend: 'measured' (the default) "
                         "times the port's kernels on the card "
                         "(MeasuredCUDABackend, which needs a CUDA "
                         "device); 'simulated' is the v5e analytic "
                         "model, run on the CPU")
    ap.add_argument("--transfer", default="none",
                    help="'none' (full local gather), 'nearest' (pick "
                         "the closest populated registry cell as "
                         "donor; needs --registry), or a donor "
                         "artifact path: warm-start from the donor's "
                         "gathered rows and only time "
                         "--calibration-dims locally")
    ap.add_argument("--calibration-dims", type=int, default=32,
                    help="donor dims re-timed locally by a transfer "
                         "install")
    ap.add_argument("--samples", type=int, default=400,
                    help="install budget (paper scale: 1763)")
    ap.add_argument("--bias", type=float, default=0.75,
                    help="fraction of the budget biased toward the "
                         "profile's shape regions / routine mix")
    ap.add_argument("--space", default="default",
                    choices=["default", "enlarged"],
                    help="candidate ConfigSpace the install searches: "
                         "'enlarged' is ~11x the paper grid (3*2^k chip "
                         "counts, extra tiles, TRSM pipeline depth) and "
                         "pairs with --timing-budget")
    ap.add_argument("--timing-budget", type=int, default=None,
                    help="total timed (dim x config) cells; when set, a "
                         "cost-model beam search picks which cells to "
                         "time instead of the dense grid")
    ap.add_argument("--beam-width", type=int, default=8,
                    help="beam width of the budgeted install's search")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    profile = build_profile(args)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    profile.save(args.out)
    print(f"[profile] merged profile -> {args.out}")
    print(profile.table())

    if not args.install:
        return
    # install over every known routine: observed ones get the lion's
    # share via the profile quotas, unobserved ones keep floor coverage
    space = None
    if args.space == "enlarged":
        from repro_torch.core import ConfigSpace
        space = ConfigSpace.enlarged()
    cfg = InstallConfig(
        n_samples=args.samples, routines=tuple(ROUTINES),
        workload=profile, workload_bias=args.bias, seed=args.seed,
        space=space, timing_budget=args.timing_budget,
        beam_width=args.beam_width,
        calibration_dims=args.calibration_dims)
    if args.backend == "measured":
        from repro_torch.core.timing import MeasuredCUDABackend
        backend = MeasuredCUDABackend(seed=args.seed, repeats=3)
    else:
        backend = SimulatedBackend(seed=args.seed)
    grid = (f"{args.space} space, "
            + (f"budget {args.timing_budget} cells, beam "
               f"{args.beam_width}" if args.timing_budget
               else "dense grid"))
    transfer = None if args.transfer == "none" else args.transfer
    if args.registry:
        from repro_torch.core.registry import (ArtifactRegistry,
                                         HardwareFingerprint)
        reg = ArtifactRegistry(args.registry)
        fp = HardwareFingerprint.collect()
        print(f"[profile] mix-weighted install: {args.samples} samples, "
              f"bias {args.bias}, {grid}, {args.backend} backend -> "
              f"registry cell {fp.key()}")
        report = reg.install(fp, backend, cfg, transfer_from=transfer,
                             verbose=True)
    else:
        if transfer == "nearest":
            sys.exit("[profile] --transfer nearest needs --registry "
                     "(there is no registry to pick a neighbour from)")
        print(f"[profile] mix-weighted install: {args.samples} samples, "
              f"bias {args.bias}, {grid}, {args.backend} backend -> "
              f"{args.artifact}")
        report = install(backend, cfg, artifact_dir=args.artifact,
                         transfer_from=transfer, verbose=True)
    print(report.table())


if __name__ == "__main__":
    main()
