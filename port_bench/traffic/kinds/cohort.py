"""Closed-loop slide cohorts through ``ServingEngine.predict_slide``.

``clients`` threads (a loader beside a predict loop, each) send slides
from the host pool, each its next one when its previous map returns, until
``--seconds`` have passed; requests in flight finish and count. The pool
holds one slide per (h, w) of the traffic's multiset; the order is
successive seeded permutations of it (:func:`slides.order`). A request
is timed from its submission to its map on the host.

The check draws, from the seed, ``sample_requests`` of the answered
requests (the largest slide among them) and ``cells_per_request`` map
cells of each, makes each sampled request's slide again, and compares the
served class of each cell with the reference's scores there
(:func:`reference.maps.widest_gap`)."""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ...core import program
from ...core.record import Run, service_intervals
from ...core.seeds import derive
from ...core.trace import SubWindow
from ...reference.maps import dense_cell_scores, fcn_cell_scores, gap_numbers
from . import slides

HEAD_PATCHES = 64  # patches of the seed's slides the head is fitted to


class Kind:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        self.sizes = [tuple(s) for s in self.t["sizes"]]
        self.mode = self.t["mode"]

    # ------------------------------------------------------------------
    def setup(self) -> None:
        ctx, dev = self.ctx, self.ctx.device
        self.sd = ctx.family.make_weights(ctx.cfg, ctx.seed, dev)
        self.pool = []
        for j, (h, w) in enumerate(self.sizes):
            self.pool.append(slides.make_slide(ctx.seed, j, h, w, self.t["block_px"], dev)
                             .cpu().numpy())
        ctx.family.fit_head(ctx.cfg, self.sd, self._head_patches(), ctx.seed)
        self.counts = [ctx.family.request_counts(ctx.cfg, self.mode, h, w) for h, w in self.sizes]
        self.n_equiv = [len_dense(h, w, ctx.cfg) for h, w in self.sizes]
        self.engine = program.build_engine(ctx.cfg, ctx.family, self.sd, self.mode, dev)
        for img in self.pool:  # every shape the traffic sends, once
            self.engine.predict_slide(image=img, mode=self.mode)
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def _head_patches(self) -> torch.Tensor:
        rng = np.random.default_rng(derive(self.ctx.seed, "head patches"))
        ps = self.ctx.cfg["patch_size"]
        out = []
        for k in range(HEAD_PATCHES):
            img = self.pool[k % len(self.pool)]
            y = int(rng.integers(0, img.shape[0] - ps + 1))
            x = int(rng.integers(0, img.shape[1] - ps + 1))
            out.append(img[y:y + ps, x:x + ps])
        return torch.from_numpy(np.stack(out)).to(self.ctx.device)

    # ------------------------------------------------------------------
    def window(self, seconds: float, trace: bool) -> Run:
        ctx = self.ctx
        side = self.t["request_block"]
        locks = [threading.Lock() for _ in self.sizes]
        counter = {"next": 0}
        take = threading.Lock()
        records: list[dict] = []
        sched = slides.order(ctx.seed, len(self.sizes), 1 << 20)

        def client():
            while True:
                with take:
                    i = counter["next"]
                    counter["next"] += 1
                if time.perf_counter() - t0 >= seconds:
                    return
                j = int(sched[i])
                img = self.pool[j]
                h, w = self.sizes[j]
                with locks[j]:
                    y, x, blk = slides.request_block(ctx.seed, i, h, w, side)
                    saved = img[y:y + side, x:x + side].copy()
                    img[y:y + side, x:x + side] = blk
                    rec = {"i": i, "size": j, "h": h, "w": w, "n_equiv": self.n_equiv[j],
                           **self.counts[j], "t_submit": time.perf_counter()}
                    try:
                        amap, _ = self.engine.predict_slide(image=img, mode=self.mode)
                        rec.update(ok=True, map=amap)
                    except Exception as e:  # noqa: BLE001 — a failed request is counted
                        rec.update(ok=False, error=f"{type(e).__name__}: {e}")
                    rec["t_done"] = time.perf_counter()
                    img[y:y + side, x:x + side] = saved
                records.append(rec)

        threads = [threading.Thread(target=client, name=f"port-bench-client-{c}", daemon=True)
                   for c in range(self.t["clients"])]
        t0 = time.perf_counter()
        sub = SubWindow(t0, *trace_span(seconds)) if trace else None
        for t in threads:
            t.start()
        if sub is not None:
            sub.run()
        for t in threads:
            t.join()
        run = Run(ctx.cell, ctx.cfg, self.t, ctx.seed, seconds, requests=records)
        run.t0 = min((r["t_submit"] for r in records), default=t0)
        run.t1 = max((r["t_done"] for r in records), default=t0)
        if sub is not None:
            spans = [(a, b, f"engine.predict_slide {self.mode} {r['h']}x{r['w']}")
                     for a, b, r in service_intervals(records)]
            run.trace = sub.finish(spans)
        return run

    # ------------------------------------------------------------------
    def close(self) -> None:
        self.engine = None
        program.free(self.ctx.device)

    def check(self, run: Run, control: bool) -> dict:
        ctx, spec = self.ctx, self.ctx.checks
        ok = [r for r in run.requests if r.get("ok")]
        if not ok:
            return {"numbers": {}, "correct": False, "why": "no request was answered"}
        rng = np.random.default_rng(derive(ctx.seed, "check"))
        largest = max(ok, key=lambda r: (r["h"] * r["w"], -r["i"]))
        rest = [r for r in ok if r is not largest]
        k = min(spec["sample_requests"] - 1, len(rest))
        sample = [largest] + [rest[int(i)] for i in rng.choice(len(rest), k, replace=False)]
        ref = ctx.family.Reference(ctx.cfg, self.sd, ctx.device)
        cfg = ctx.cfg
        ref_s, ctl_s, served = [], [], []
        for rec in sorted(sample, key=lambda r: r["i"]):
            amap = rec["map"]
            cells = np.stack([rng.integers(0, amap.shape[0], spec["cells_per_request"]),
                              rng.integers(0, amap.shape[1], spec["cells_per_request"])], 1)
            slide = slides.request_slide(ctx.seed, rec, self.t, ctx.device)
            for use_control in ((False, True) if control else (False,)):
                if self.mode == "fcn":
                    e = cfg["engine"]
                    s = fcn_cell_scores(slide, ref.slide_features(use_control), ref.fc_w,
                                        ref.fc_b, cells, e["tile"], e["halo"],
                                        cfg["patch_size"], cfg["downscale"])
                else:
                    s = dense_cell_scores(slide, ref.slide_logits(use_control), cells,
                                          cfg["patch_size"], cfg["stride"], cfg["downscale"])
                (ctl_s if use_control else ref_s).append(s.cpu())
            served.append(amap[cells[:, 0], cells[:, 1]])
            del slide
        ref_all = torch.cat(ref_s)
        got = gap_numbers(ref_all, np.concatenate(served))
        out = judge(got, spec, len(ok) == len(run.requests))
        out.update(cells=int(ref_all.shape[0]), requests_checked=len(sample))
        if control:  # the control judged by the same limits: it has to come out false
            out["control"] = gap_numbers(ref_all, torch.cat(ctl_s).argmax(1).numpy())
            out["control_correct"] = judge(out["control"], spec, len(ok) == len(run.requests))[
                "correct"]
        return out


def judge(got: dict, spec: dict, all_answered: bool) -> dict:
    """The numbers that ``spec["limits"]`` names, each beside its limit;
    correct when every answer came and each number is within its limit. A
    check that names no limit is refused: a cell's limits are set from its
    readings on the chip before it runs."""
    if not spec["limits"]:
        raise ValueError("the cell's check names no limit; set them from readings.py")
    numbers = {k: {"value": got[k], "limit": lim} for k, lim in spec["limits"].items()}
    ok = all_answered and all(n["value"] <= n["limit"] for n in numbers.values())
    return {"numbers": numbers, "correct": ok, "readings": got}


def trace_span(seconds: float) -> tuple[float, float]:
    """(start, length) of the traced sub-window: a few steady seconds in
    the middle of the window. It starts at 30 % of the window, as the
    profiler's own start takes a second or two before its first event."""
    return 0.3 * seconds, min(4.0, 0.25 * seconds)


def len_dense(h: int, w: int, cfg: dict) -> int:
    from ...core.flops import equivalent_patches

    return equivalent_patches(h, w, cfg["patch_size"], cfg["stride"])
