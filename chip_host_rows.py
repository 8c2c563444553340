"""Rows of ``chip_smoke.py`` on one card, for readings of two trees side by
side.

    python3 chip_host_rows.py TREE RUNS
    python3 chip_host_rows.py TREE RUNS --int8

By default, the host-bound rows of phase 20: the predict CLI's
``--host_loop`` random and dense modes and the ONDISK dense sampler through
``process_on_device``, on phase 20's seeded 16384² slide (layer 2) and
seeded ResNet-18, each ``RUNS`` times in turn. The native host library is
built first where the tree has one, outside every timed window. With
``--int8``, the int8 rows: phase 3's K1 int8 calls (``check_k1_int8``: each
layout bit-equal to its plain version, then timed), then phase 12's exact
int8 16384² predict and phase 13's fcn headline predict (pack 8,
pre-tiled), each best of ``MAIN_TIMED_RUNS``, ``RUNS`` times in turn.

``TREE`` is a checkout of the repository (``.`` for this one; a parent
unpacked with ``git archive`` into a gitignored directory for the other
side). Prints one line ``HOST_ROWS {json}`` (or ``INT8_ROWS {json}``) with
the readings of every run and the card's name and power limit. Run parent,
change, change, parent in one call to compare two commits.
"""
import json
import os
import sys
import tempfile
import time
from pathlib import Path

if __name__ == "__main__":
    tree, runs = Path(sys.argv[1]).resolve(), int(sys.argv[2])
    os.chdir(tree)
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from deephisto_tpu_torch import _build
    from deephisto_tpu_torch.predict import dense_coords, process_on_device
    from deephisto_tpu_torch.samplers import FullImageDenseSampler, SamplerExecutionMode
    from deephisto_tpu_torch.slide import DHSlide
    from deephisto_tpu_torch.train import save_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    if "--int8" in sys.argv[3:]:
        from deephisto_tpu_torch.predict import (
            fcn_equivalent_patches,
            predict_full_fcn,
            predict_full_fused,
            stage_for_fcn,
        )

        device = torch.device("cuda", 0)
        slide = cs.seeded_slide(device)
        dense = torch.from_numpy(dense_coords(cs.MAIN_SIDE, cs.MAIN_SIDE, cs.PS, cs.STRIDE))
        k1 = {k: v["ms"] for k, v in cs.check_k1_int8(slide, dense, device)["by_layout"].items()}
        qexact, qpack, _ = cs.seeded_int8(device, cs.seeded_model(device, depth=18, stem="s2d"),
                                          slide, dense)
        staged = stage_for_fcn(slide, tile=cs.FCN_TILE, halo=cs.FCN_HALO, pack=8, pre_tile=True)
        n_equiv = fcn_equivalent_patches(cs.MAIN_SIDE, cs.MAIN_SIDE)
        rec = {"exact_int8_patches_per_s": [], "fcn_headline_patches_per_s": []}
        for r in range(runs):
            best_s = cs.run_timed(lambda: predict_full_fused(slide, qexact, cs.N_CLASSES),
                                  "exact int8 predict", cs.MAIN_SIDE)[3]
            rec["exact_int8_patches_per_s"].append(len(dense) / best_s)
            best_s = cs.run_timed(
                lambda: predict_full_fcn(staged, qpack, cs.N_CLASSES, tile=cs.FCN_TILE,
                                         halo=cs.FCN_HALO, tile_batch=cs.FCN_TB),
                "fcn headline predict", cs.MAIN_SIDE)[3]
            rec["fcn_headline_patches_per_s"].append(n_equiv / best_s)
        print("INT8_ROWS " + json.dumps({"tree": str(tree), "card": cs.card_line(), "k1_int8_ms": k1,
                                         **rec}), flush=True)
        sys.exit(0)
    native = cs.build_native() if hasattr(cs, "build_native") else None
    device = torch.device("cuda", 0)
    rec = {"host_loop_random": [], "host_loop_dense": [], "ondisk_process_on_device": []}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ds = cs.pred_dataset(root, device)
        dhs = ds / "images" / "test" / "test_00.dhs"
        with DHSlide(dhs) as s:
            layer2 = s.load_layer(cs.PRED_LAYER)
        image = torch.from_numpy(layer2).to(device)
        dense = torch.from_numpy(dense_coords(cs.PRED_SIDE, cs.PRED_SIDE, cs.PS, cs.STRIDE))
        model = cs.seeded_model(device, depth=18)
        cs.center_head(model, model.fc, image, dense[:: max(1, len(dense) // 64)][:64])
        weights = save_model(root / "ck" / "best_model.msgpack", model)
        os.environ["DEEPHISTO_DATASET"] = str(ds)
        n_dense = len(dense)
        for r in range(runs):
            for label in ("host_loop_random", "host_loop_dense"):
                row = cs.run_predict_cli(label, cs.PRED_MODES[label], weights,
                                         root / "out" / f"{label}{r}")
                res, spy = row.pop("result"), row.pop("spy")
                n = len(spy.draws) * cs.PRED_BS if label == "host_loop_random" else n_dense
                rec[label].append(n / row["predict_s"])
            sampler = FullImageDenseSampler(dhs, layer=cs.PRED_LAYER, patch_size=cs.PS,
                                            batch_size=cs.PRED_BS, stride=cs.STRIDE,
                                            mode=SamplerExecutionMode.ONDISK_MULTIPROC)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            process_on_device(sampler, res["model"], cs.N_CLASSES, downscale=cs.D, verbose=False)
            torch.cuda.synchronize()
            rec["ondisk_process_on_device"].append(n_dense / (time.perf_counter() - t0))
    print("HOST_ROWS " + json.dumps({"tree": str(tree), "native_build": native, "card": cs.card_line(),
                                "patches_per_s": rec}), flush=True)
