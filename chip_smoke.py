#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Device: the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel).
2. Kernels against their plain PyTorch versions, on the card, at the main
   path's shapes (one SpaceNet image, the Poker Hand groups and chunks, the
   full Poker Hand set), a ragged N with a random mask, R = 4 restarts
   with shared and with per-restart points, and D = 130, K = 16.  Labels
   must agree except on near-ties, statistics within stated tolerances,
   two runs of a kernel must give bit-identical outputs, and so must an
   unmasked call (no weight vector) and one with an all-ones mask.  Each
   kernel is timed (CUDA events, warm-up, median) beside its plain
   version and its memory/compute bound.
3. The port's main path through its CLI entry point, with the launch
   counters zeroed just before and read just after: the paper's land-use
   case (full-size SpaceNet images, k = 6, k-means and EM) and the full
   Poker Hand set (6 groups of 170,835 rows, k-means, k = 10, 4 chunks).
   The profiler (CUPTI) splits a wrapper call into the kernel's own device
   time and the rest, and a production fit into device-busy and idle time.
   Then the kernel path is held against the plain path on a small input,
   and on the full-size SpaceNet k-means harvest from the same seeds.
4. A ``{"kernels": [...]}`` line, the card's name and power limit, and the
   last line ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero without the last
line.  Without CUDA, or outside a checkout of the repository, it fails.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

# (bytes/s, fp32 flop/s) of the card by name: NVIDIA data sheets, dense,
# at the full power limit; an unknown card is refused rather than guessed
CARD_PEAKS = {
    "H100 80GB HBM3": (3.35e12, 67e12),     # H100 SXM
    "H100 SXM": (3.35e12, 67e12),
    "H100 NVL": (3.9e12, 60e12),
    "H100 PCIe": (2.0e12, 51e12),
}
REPLACES = {
    "kmeans_assign": "src/repro/kernels/kmeans_assign/kernel.py:85",
    "gmm_estep": "src/repro/kernels/gmm_estep/kernel.py:81",
}
# label agreement: a row may take another cluster only when its two best
# candidates are within this fraction of the row's term magnitudes (fp32
# dot products summed in another order)
TIE_RTOL = 1e-5
# statistics: max |kernel - plain| <= STAT_RTOL * max |plain| (per-block
# row-order sums + a fixed tree over blocks vs cuBLAS / index_add order);
# counts differ by at most the rows that changed cluster at a near-tie
STAT_RTOL = 1e-4
# J / loglik: relative, same reason
OBJ_RTOL = 1e-4


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(torch, reps: int, fn, *args, **kw) -> float:
    """Median over ``reps`` timed calls ``fn(*args, **kw)`` (CUDA events),
    after a warm-up."""
    for _ in range(3):
        fn(*args, **kw)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args, **kw)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_us(prof, needle: str):
    """(launches, total µs) of device time for kernels whose name contains
    ``needle``, from a torch.profiler run; (0, 0.0) when nothing matched."""
    n, total = 0, 0.0
    for e in prof.key_averages():
        if needle in e.key:
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0.0)
            n += e.count
            total += t
    return n, total


def busy_us(prof) -> float:
    """Device time of every kernel and copy in a profiler run (µs)."""
    total = 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0.0)
            total += t
    return total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "runs the port on a GPU only", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.core import em_gmm
    from repro_torch.data import poker, spacenet_pixels
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.gmm_estep import ops as gops, ref as gref
    from repro_torch.kernels.kmeans_assign import ops as kops, ref as kref
    from repro_torch.launch import cluster

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"[device] {name} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    peaks = next((v for k, v in CARD_PEAKS.items() if k in name), None)
    if peaks is None:
        raise RuntimeError(f"no published peaks for {name!r} in CARD_PEAKS")
    bw, flops = peaks
    t0 = time.perf_counter()
    build_s = build.build_all()
    print(f"[build] {len(build.SOURCES)} sources in {build_s:.2f}s "
          f"(wall {time.perf_counter() - t0:.2f}s) -> {build.BUILD_DIR}")

    # ---------------------------------------------------------------- 2 --
    gen = torch.Generator(device=dev).manual_seed(0)
    img = torch.as_tensor(spacenet_pixels(1, k_true=6, seed=0)[0]).to(dev)
    pk = torch.as_tensor(poker(n=1_025_010, seed=0)).to(dev)
    # the widest shape the kernels take beyond the main path (shared memory
    # past the default 48 KB per block)
    wide = torch.randn(20_000, 130, generator=gen, device=dev)

    def pick(x, k):
        idx = torch.randperm(x.shape[0], generator=gen, device=dev)[:k]
        return x[idx].contiguous()

    def ragged_mask(n):
        return (torch.rand(n, generator=gen, device=dev) > 0.3).float()

    # (label, x, w, k, restarts-mode); x [N, D] or [R, N, D]
    cases = [
        ("spacenet image 177828x3 k6", img, None, 6, None),
        ("poker chunk 42709x11 k10", pk[:42_709], None, 10, None),
        ("poker group 170835x11 k10", pk[:170_835], None, 10, None),
        ("poker full 1025010x11 k10", pk, None, 10, None),
        ("ragged 100003x7 k5 masked", pk[:100_003, :7].contiguous(),
         ragged_mask(100_003), 5, None),
        ("R=4 shared 177828x3 k6", img, None, 6, "shared"),
        ("R=4 per-restart 4x42709x11 k10",
         pk[:4 * 42_709].reshape(4, 42_709, 11), None, 10, "per"),
        ("wide 20000x130 k16", wide, None, 16, None),
    ]
    results = {"kmeans_assign": [], "gmm_estep": []}

    def check_labels(op, label, lk, lp, score, scale, maximize):
        """Equal labels except at near-ties of the plain scores."""
        lk, lp = lk.reshape(-1), lp.reshape(-1)
        score = score.reshape(lk.shape[0], -1)
        scale = scale.reshape(-1)
        top2 = torch.topk(score, 2, dim=1, largest=maximize).values
        near = (top2[:, 0] - top2[:, 1]).abs() <= TIE_RTOL * scale
        diff = (lk != lp) & (lp >= 0)
        valid = lp >= 0
        sk = torch.gather(score, 1, lk.clamp_min(0).long()[:, None])[:, 0]
        sp = torch.gather(score, 1, lp.clamp_min(0).long()[:, None])[:, 0]
        bad = diff & ((sk - sp).abs() > TIE_RTOL * scale)
        if int(bad.sum()) or not torch.equal(lk < 0, lp < 0):
            raise AssertionError(f"{op} {label}: {int(bad.sum())} labels "
                                 "differ beyond a near-tie")
        return int((near & valid).sum()), int(diff.sum())

    def close(op, label, what, a, b, rtol):
        err = float((a - b).abs().max())
        lim = rtol * max(float(b.abs().max()), 1.0)
        if not err <= lim:
            raise AssertionError(f"{op} {label} {what}: max err {err} > {lim}")
        return err

    for label, x, w, k, rmode in cases:
        r = 4 if rmode else 1
        n, d = x.shape[-2], x.shape[-1]
        flat = x.reshape(-1, d)
        if rmode:
            c = torch.stack([pick(flat, k) for _ in range(r)])
        else:
            c = pick(flat, k)
        x3 = x if x.ndim == 3 else x[None]
        # no mask: the kernels read no weights (w2 None), as on the main path
        w2 = None if w is None else (w if w.ndim == 2 else w[None])
        w_elems = 0 if w2 is None else w2.numel()
        ones = torch.ones_like(x[..., 0]) if w is None else None

        # ---- kmeans_assign
        out = kops.kmeans_assign(x, c, mask=w)
        out2 = kops.kmeans_assign(x, c, mask=w)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, out2)):
            raise AssertionError(f"kmeans_assign {label}: two runs differ")
        if w is None and not all(torch.equal(a, b) for a, b in zip(
                out, kops.kmeans_assign(x, c, mask=ones))):
            raise AssertionError(f"kmeans_assign {label}: no mask differs "
                                 "from an all-ones mask")
        ref = kref.kmeans_assign_plain(x3, w2, c)
        c3 = c if c.ndim == 3 else c[None]
        xs = x3.expand(r, n, d)
        x2 = (xs * xs).sum(-1)
        d2 = (x2[..., None] - 2 * xs @ c3.transpose(1, 2)
              + (c3 * c3).sum(-1)[:, None, :])
        scale = x2 + (c3 * c3).sum(-1).max(-1).values[:, None]
        near, nd = check_labels("kmeans_assign", label, out[0], ref[0], d2,
                                scale, maximize=False)
        errs = [close("kmeans_assign", label, "sums", out[1], ref[1],
                      STAT_RTOL),
                close("kmeans_assign", label, "J", out[3], ref[3], OBJ_RTOL)]
        cnt_err = float((out[2] - ref[2]).abs().max())
        if cnt_err > nd:
            raise AssertionError(f"kmeans_assign {label}: counts differ by "
                                 f"{cnt_err} with {nd} label changes")
        reps = 20 if n * r <= 200_000 else 10
        ms = time_ms(torch, reps, kops.kmeans_assign, x, c, mask=w)
        plain_ms = time_ms(torch, reps, kref.kmeans_assign_plain, x3, w2, c)
        rows = n * r
        byts = 4 * (x3.numel() + w_elems + c3.numel() + r * n
                    + r * (k * d + k + 1))
        ops = rows * (2 * d + k * (2 * d + 3) + 2 * d + 3)
        results["kmeans_assign"].append(dict(
            shape=label, ms=ms, plain_ms=plain_ms, bytes=byts, ops=ops,
            bound_ms=1e3 * max(byts / bw, ops / flops),
            bound_by="bytes" if byts / bw >= ops / flops else "operations",
            max_abs_err=max(errs + [cnt_err]), near_ties=near,
            label_changes=nd))

        # ---- gmm_estep on k-means-seeded GMM parameters
        if rmode:
            ps = [em_gmm.init_from_kmeans(x3[min(i, x3.shape[0] - 1)], c[i])
                  for i in range(r)]
            means, var, lw = (torch.stack(t).contiguous() for t in zip(*ps))
        else:
            means, var, lw = em_gmm.init_from_kmeans(x3[0], c)
        # a pass of EM so the variances differ per component
        o = gops.gmm_estep(x, means, var, lw, mask=w)
        nt = (torch.full((1,), float(n), device=dev) if w2 is None
              else w2.sum(-1))
        if rmode:
            ps = [em_gmm.mstep(em_gmm.GMMParams(means[i], var[i], lw[i]),
                               o[2][i], o[3][i], o[4][i],
                               nt[min(i, nt.shape[0] - 1)])
                  for i in range(r)]
            means, var, lw = (torch.stack(t).contiguous() for t in zip(*ps))
        else:
            means, var, lw = em_gmm.mstep(em_gmm.GMMParams(means, var, lw),
                                          o[2], o[3], o[4], nt[0])
        out = gops.gmm_estep(x, means, var, lw, mask=w)
        out2 = gops.gmm_estep(x, means, var, lw, mask=w)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, out2)):
            raise AssertionError(f"gmm_estep {label}: two runs differ")
        if w is None and not all(torch.equal(a, b) for a, b in zip(
                out, gops.gmm_estep(x, means, var, lw, mask=ones))):
            raise AssertionError(f"gmm_estep {label}: no mask differs from "
                                 "an all-ones mask")
        ref = gref.gmm_estep_plain(x3, w2, means, var, lw)
        m3 = means if means.ndim == 3 else means[None]
        v3 = var if var.ndim == 3 else var[None]
        l3 = lw if lw.ndim == 2 else lw[None]
        a3, b3 = 1.0 / v3, m3 / v3
        cst = l3 - 0.5 * ((m3 ** 2 * a3).sum(-1) + torch.log(v3).sum(-1)
                          + d * 1.8378770664093453)
        quad = (xs * xs) @ a3.transpose(1, 2)
        lin = xs @ b3.transpose(1, 2)
        lp = cst[:, None, :] - 0.5 * quad + lin
        scale = (cst.abs()[:, None, :] + 0.5 * quad + lin.abs()).max(-1).values
        near, nd = check_labels("gmm_estep", label, out[0], ref[0], lp, scale,
                                maximize=True)
        errs = [close("gmm_estep", label, "loglik", out[1], ref[1], OBJ_RTOL)]
        for what, i in (("r_sum", 2), ("r_x", 3), ("r_x2", 4)):
            errs.append(close("gmm_estep", label, what, out[i], ref[i],
                              STAT_RTOL))
        ms = time_ms(torch, reps, gops.gmm_estep, x, means, var, lw, mask=w)
        plain_ms = time_ms(torch, reps, gref.gmm_estep_plain, x3, w2, means,
                           var, lw)
        byts = 4 * (x3.numel() + w_elems + 3 * m3.numel() + l3.numel()
                    + r * n + r * (k + 2 * k * d + 1))
        ops = rows * (k * (4 * d + 3) + 4 * k + k * (4 * d + 1) + 2)
        results["gmm_estep"].append(dict(
            shape=label, ms=ms, plain_ms=plain_ms, bytes=byts, ops=ops,
            bound_ms=1e3 * max(byts / bw, ops / flops),
            bound_by="bytes" if byts / bw >= ops / flops else "operations",
            max_abs_err=max(errs), near_ties=near, label_changes=nd))

    for op, rows_ in results.items():
        for row in rows_:
            print(f"[kernel] {op:13s} {row['shape']:32s} {row['ms']:.4f} ms "
                  f"| plain {row['plain_ms']:.4f} ms | bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}) | max err "
                  f"{row['max_abs_err']:.3g} | near-ties {row['near_ties']} "
                  f"changed {row['label_changes']}")

    # device time of the kernel alone vs the wrapper call (host work and
    # the partial reduction), from the profiler's CUPTI trace
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for label, x, k in (("spacenet image 177828x3 k6", img, 6),
                        ("poker full 1025010x11 k10", pk, 10)):
        c = pick(x, k)
        means, var, lw = em_gmm.init_from_kmeans(x, c)
        for op, fn, args in (("kmeans_assign", kops.kmeans_assign, (x, c)),
                             ("gmm_estep", gops.gmm_estep,
                              (x, means, var, lw))):
            for _ in range(3):
                fn(*args)
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                for _ in range(20):
                    fn(*args)
                torch.cuda.synchronize()
            n, us = device_us(prof, f"{op}_kernel")
            kern_ms = f"{us / n / 1e3:.4f} ms" if n else "not measured"
            row = next(r_ for r_ in results[op] if r_["shape"] == label)
            row["kernel_only_ms"] = us / n / 1e3 if n else None
            print(f"[profile] {op:13s} {label:32s} kernel alone {kern_ms} "
                  f"over {n} launches | device busy per call "
                  f"{busy_us(prof) / 20 / 1e3:.4f} ms | wrapper "
                  f"{row['ms']:.4f} ms")

    # ---------------------------------------------------------------- 3 --
    runs = [
        ("spacenet k-means", "kmeans_assign",
         ["--dataset", "spacenet", "--k", "6", "--train-groups", "4",
          "--prod-groups", "2", "--algorithm", "kmeans"]),
        ("spacenet EM", "gmm_estep",
         ["--dataset", "spacenet", "--k", "6", "--train-groups", "4",
          "--prod-groups", "2", "--algorithm", "em"]),
        ("poker k-means", "kmeans_assign",
         ["--dataset", "poker", "--n", "1025010", "--group-size", "170835",
          "--train-groups", "4", "--prod-groups", "2", "--k", "10",
          "--chunks", "4", "--algorithm", "kmeans"]),
    ]
    dispatch.reset_launches()
    main_path = {}
    for title, op, argv in runs:
        before = dict(dispatch.LAUNCHES)
        t0 = time.perf_counter()
        out = cluster.main(argv)
        wall = time.perf_counter() - t0
        launched = dispatch.LAUNCHES[op] - before[op]
        if launched <= 0:
            raise AssertionError(f"{title}: {op} was never launched")
        if out["device"] != "cuda":
            raise AssertionError(f"{title} ran on {out['device']}")
        if not (0.0 < out["h_star"] < float("inf")
                and 0.0 <= out["achieved_accuracy"] <= 1.0):
            raise AssertionError(f"{title}: bad result {out}")
        main_path[title] = dict(
            h_star=out["h_star"],
            iters_earlystop=out["iters_earlystop_per_group"],
            iters_full=out["iters_full_per_group"],
            achieved_accuracy=out["achieved_accuracy"],
            time_train_s=out["time_train_s"],
            time_actual_s=out["time_actual_s"],
            time_full_s=out["time_full_s"],
            cost_effectiveness=out["cost_effectiveness"], wall_s=wall,
            launches={o: dispatch.LAUNCHES[o] - before[o]
                      for o in dispatch.LAUNCHES})
        print(f"[pipeline] {title}: {json.dumps(main_path[title])}")
    launches = dict(dispatch.LAUNCHES)
    for op in results:
        if launches[op] <= 0:
            raise AssertionError(f"main path never launched {op}")

    # where the time goes in a production fit: device busy time (profiler)
    # against the unprofiled wall time of the same fit
    for alg, h_star in (("kmeans", 0.0),
                        ("em", main_path["spacenet EM"]["h_star"])):
        kw = dict(max_iters=300, seed=100)
        cluster.run_production(img, 6, alg, h_star, **kw)
        _, _, iters, wall = cluster.run_production(img, 6, alg, h_star, **kw)
        with profile(activities=acts) as prof:
            cluster.run_production(img, 6, alg, h_star, **kw)
        busy = busy_us(prof) / 1e6
        n_k, k_us = (sum(v) for v in zip(
            *(device_us(prof, f"{op}_kernel") for op in results)))
        print(f"[where] spacenet image {alg} fit: {iters} iters, wall "
              f"{wall * 1e3:.2f} ms ({wall / iters * 1e3:.4f} ms/iter), "
              f"device busy {busy * 1e3:.2f} ms (share "
              f"{busy / wall:.3f}; idle {1 - busy / wall:.3f}), "
              f"clustering kernels {k_us / 1e3:.2f} ms over {n_k} launches")

    # the kernel path against the plain path on one small input: same
    # groups, same seeds, cuda vs cpu
    from repro_torch.core.sampling import random_groups
    from repro_torch.data import load
    groups = random_groups(load("skin", n=8000), 2000, max_groups=4)
    for alg, k, mi, chunks in (("kmeans", 3, 60, 4), ("em", 2, 12, 4)):
        got = {}
        for device in ("cuda", "cpu"):
            g0 = torch.Generator().manual_seed(7)
            inits = []
            for g in groups:
                xg = torch.as_tensor(g)
                idx = torch.randperm(xg.shape[0], generator=g0)[:k]
                c0 = xg[idx]
                p = c0 if alg == "kmeans" else em_gmm.init_from_kmeans(xg, c0)
                inits.append(p)
            got[device] = cluster.run_pipeline(
                groups[:2], groups[2:], k=k, algorithm=alg,
                desired_accuracy=0.99, max_iters=mi, chunks=chunks,
                train_inits=inits[:2], prod_inits=inits[2:], device=device)
        a, b = got["cuda"], got["cpu"]
        hs_rel = abs(a["h_star"] - b["h_star"]) / b["h_star"]
        summary = dict(h_star=(a["h_star"], b["h_star"]),
                       early=(a["iters_earlystop_per_group"],
                              b["iters_earlystop_per_group"]),
                       full=(a["iters_full_per_group"],
                             b["iters_full_per_group"]),
                       acc=(a["achieved_accuracy"], b["achieved_accuracy"]))
        print(f"[small {alg}] cuda vs cpu: {json.dumps(summary)}")
        # k-means stops on frozen centroids and must agree exactly; EM's
        # stops read loglik, whose fp32 sums differ in the last bits
        tol_h, tol_acc = (1e-3, 1e-6) if alg == "kmeans" else (1e-2, 1e-3)
        if (hs_rel > tol_h
                or abs(a["achieved_accuracy"] - b["achieved_accuracy"])
                > tol_acc
                or (alg == "kmeans" and (
                    a["iters_earlystop_per_group"]
                    != b["iters_earlystop_per_group"]
                    or a["iters_full_per_group"]
                    != b["iters_full_per_group"]))):
            raise AssertionError(f"small {alg}: cuda and cpu disagree")

    # the land-use harvest at full size (four SpaceNet images, k = 6) on
    # both paths from the same CPU-drawn k-means++ seeds; tests/
    # test_torch_pipeline.py holds the cpu side against the reference's
    # harvest under these seeds (both floor h* at 1e-12)
    from repro_torch.core import kmeans as pkm
    sp = spacenet_pixels(4, k_true=6)
    sp_inits = [pkm.kmeans_plus_plus_init(
        torch.as_tensor(g), 6, generator=torch.Generator().manual_seed(gi))
        for gi, g in enumerate(sp)]
    hs = {}
    for device in ("cuda", "cpu"):
        model, _ = cluster.train_regression(
            sp, 6, "kmeans", max_iters=300, family="quadratic",
            inits=sp_inits, device=device)
        hs[device] = (model.threshold_for(0.99), model.regression.coeffs)
    print(f"[full-size harvest] spacenet k-means cuda vs cpu: "
          f"{json.dumps(hs)}")
    # fp32 J summed in another order moves the h tail, which near the fixed
    # point is rounding noise of J
    if abs(hs["cuda"][0] - hs["cpu"][0]) > 1e-2 * hs["cpu"][0]:
        raise AssertionError("full-size harvest: cuda and cpu h* disagree")

    # ---------------------------------------------------------------- 4 --
    kern = []
    for op, rows_ in results.items():
        main_row = rows_[0]          # one SpaceNet image: the land-use path
        kern.append({
            "name": op, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{op}.cu",
            "replaces": REPLACES[op], "launches": launches[op],
            "max_abs_err": max(r_["max_abs_err"] for r_ in rows_),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": kern}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
