"""Serving daemon CLI: ``python -m deephisto_tpu_torch.serve``.

Loads a trained checkpoint (the trainer's config YAML and
``best_model.msgpack``), optionally post-training-quantizes it, optionally
runs a slide of an expected shape first, then serves HTTP until interrupted
(``server.py`` has the route table). It runs on the current CUDA device
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys

from .engine import MODES, ServingEngine
from .server import serve_forever


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m deephisto_tpu_torch.serve",
        description="Online full-WSI / patch prediction over a trained checkpoint.",
    )
    p.add_argument("--config", required=True, help="model config YAML")
    p.add_argument("--weights", required=True,
                   help="weights: best_model.msgpack (flax msgpack, written by either "
                        "package), or a train-state checkpoint directory of "
                        "deephisto_tpu_torch.train.dist_ckpt (its latest step)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8477)
    p.add_argument("--mode", choices=MODES, default="fcn", help="default slide mode")
    p.add_argument("--int8", action="store_true",
                   help="serve the int8 PTQ model (models/quantize.py, models/quantize_vit.py)")
    p.add_argument("--calib", default=None,
                   help=".npy of (N, P, P, 3) uint8 calibration patches; without it the "
                        "model is calibrated on noise (enough to measure speed; a model "
                        "served for its answers should get real patches)")
    p.add_argument("--tile", type=int, default=1024)
    p.add_argument("--halo", type=int, default=32)
    p.add_argument("--tile-batch", type=int, default=16)
    p.add_argument("--warm", default=None, metavar="HxW",
                   help="run a slide of this shape before serving, e.g. 16384x16384 (the "
                        "kernels' build and cuDNN's algorithm picks happen then)")
    p.add_argument("--device", default=None, help="torch device (default: the current card)")
    p.add_argument("-v", "--verbose", action="store_true", help="log every request")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])

    engine = ServingEngine.from_checkpoint(
        args.config, args.weights,
        int8=args.int8, calib=args.calib, mode=args.mode,
        tile=args.tile, halo=args.halo, tile_batch=args.tile_batch, device=args.device,
    )
    if args.warm:
        h, w = (int(v) for v in args.warm.lower().split("x"))
        print(f"warming {h}x{w} {engine.default_mode} ...", flush=True)
        engine.warmup(h, w)
        print("warm.", flush=True)
    serve_forever(engine, args.host, args.port, verbose=args.verbose)


if __name__ == "__main__":
    main()
