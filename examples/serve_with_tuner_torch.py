"""Serving example of the PyTorch port: batched generation with the
ADSALA tuner in the loop (paper Fig 3 runtime workflow), on the
stablelm-1.6b smoke config, its attention on the flash kernel.

Run:  PYTHONPATH=src python examples/serve_with_tuner_torch.py
      PYTHONPATH=src python examples/serve_with_tuner_torch.py \
          --device cpu

The artifact comes from ``examples/quickstart_torch.py`` when it is
missing: the measured install on the card, or the simulated one with
``--device cpu`` (where the kernels' plain versions serve).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--artifact", default="/tmp/adsala_quickstart_torch")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("[serve-example] no CUDA device; pass --device cpu to "
                 "serve on the CPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import quickstart_torch
    from repro_torch.launch import serve

    if not os.path.exists(os.path.join(args.artifact, "model.json")):
        print("[serve-example] building the tuner artifact first ...")
        quickstart_torch.main(
            ["--artifact", args.artifact, "--device", args.device,
             "--backend",
             "measured" if args.device == "cuda" else "simulated"])
    return serve.run(
        ["--arch", "stablelm-1.6b", "--scale", "smoke",
         "--requests", "4", "--prompt-len", "32", "--gen-tokens", "12",
         "--artifact", args.artifact, "--device", args.device])


if __name__ == "__main__":
    main()
