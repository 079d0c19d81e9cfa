"""Production clustering CLI — the paper's pipeline end to end (§4, §5),
ported: full-batch mode on one device.

    PYTHONPATH=src python -m repro_torch.launch.cluster \
        --dataset spacenet --k 6 --algorithm kmeans --desired-accuracy 0.99

Pipeline: synthesize the data → random-sample it into groups → harvest
(r_i, h_i) traces from the training groups through the engine's on-device
trace → fit the Eq. 8 regression → h* = f(r*) → early-stopped production
fit per production group, plus the full-convergence reference fit →
achieved accuracy (exact Rand index) → cost report (Eq. 6/9/10).  Every
sweep runs the CUDA kernels on ``--device cuda`` (the default) and their
plain PyTorch versions on ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core import em_gmm, kmeans
from repro_torch.core.cost_model import report
from repro_torch.core.engine import ClusteringEngine, EngineConfig, as_points
from repro_torch.core.longtail_train import TrainingPlan, fit_for_config
from repro_torch.core.rand_index import rand_index
from repro_torch.core.sampling import random_groups
from repro_torch.data import load as load_data, spacenet_pixels
from repro_torch.kernels.dispatch import resolve_device


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def train_regression(groups, k: int, algorithm: str, *, max_iters: int,
                     family: str | None, seed: int = 0, inits=None,
                     device=None):
    """Fit h(r) from the training groups (paper §5.3.1): harvest full-batch
    traces on the device and fit Eq. 8.  As in the reference's full-batch
    train mode, the harvest runs unchunked whatever ``--chunks`` says
    (chunking is a memory layout there, not a regime).  ``inits[gi]``
    (optional) gives training group gi's initial parameters.  Returns
    (model, seconds)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    plan = TrainingPlan(algorithm=algorithm, k=k,
                        config=EngineConfig(max_iters=max_iters),
                        family=family, max_iters=max_iters, seed=seed)
    model = fit_for_config(plan, groups, inits=inits, device=dev)
    return model, time.perf_counter() - t0


def run_production(x, k: int, algorithm: str, h_star: float, *,
                   max_iters: int, seed: int = 0, patience: int = 3,
                   chunks: int = 1, model=None,
                   desired_accuracy: float | None = None, params0=None,
                   device=None):
    """One early-stopped production fit → (labels, objective, n_iters,
    seconds).

    Pass a fitted ``model`` + ``desired_accuracy`` to derive the threshold
    through ``EngineConfig.from_longtail``.  For k-means, ``h_star == 0.0``
    with no model is the full-convergence reference: stop only when the
    centroids freeze (an h stop at h*=0 would quit on fp32 J plateaus
    before the Lloyd fixed point).  ``params0`` overrides the k-means++
    seeding from ``seed``.  The time covers the fit alone, synchronised.
    """
    dev = resolve_device(device)
    x = as_points(x, dev)
    full_reference = (algorithm == "kmeans" and model is None
                      and float(h_star) == 0.0)
    cfg_kw = dict(max_iters=max_iters, patience=patience, chunks=chunks,
                  use_h_stop=not full_reference,
                  stop_when_frozen=(algorithm == "kmeans"))
    if model is not None:
        if desired_accuracy is None:
            raise ValueError("model routing needs desired_accuracy")
        cfg = EngineConfig.from_longtail(model, desired_accuracy, device=dev,
                                         **cfg_kw)
    else:
        cfg = EngineConfig(h_star=float(h_star), **cfg_kw)
    if params0 is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        c0 = kmeans.kmeans_plus_plus_init(x, k, generator=gen, chunks=chunks)
        params0 = c0 if algorithm == "kmeans" else em_gmm.init_from_kmeans(
            x, c0)
    eng = ClusteringEngine(algorithm, cfg, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    res = eng.fit(x, params0)
    _sync(dev)
    return (res.labels, float(res.objective), int(res.n_iters),
            time.perf_counter() - t0)


def run_pipeline(train_groups, prod_groups, *, k: int, algorithm: str,
                 desired_accuracy: float, max_iters: int,
                 family: str | None = "quadratic", chunks: int = 1,
                 instance: str = "m5.large", train_inits=None,
                 prod_inits=None, device=None) -> dict:
    """Harvest + fit on the training groups, then the early-stopped and the
    full-convergence fit of every production group; returns the summary
    the CLI prints (and writes with ``--out``).  ``train_inits`` /
    ``prod_inits`` (optional) give each group's initial parameters."""
    dev = resolve_device(device)
    model, t_train = train_regression(
        train_groups, k, algorithm, max_iters=max_iters, family=family,
        inits=train_inits, device=dev)
    h_star = model.threshold_for(desired_accuracy)
    t_actual = t_full = 0.0
    accs, iters_es, iters_fu = [], [], []
    for gi, g in enumerate(prod_groups):
        p0 = None if prod_inits is None else prod_inits[gi]
        labels, _, it1, t1 = run_production(
            g, k, algorithm, h_star, max_iters=max_iters, seed=100 + gi,
            chunks=chunks, model=model, desired_accuracy=desired_accuracy,
            params0=p0, device=dev)
        labels_f, _, it2, t2 = run_production(
            g, k, algorithm, 0.0, max_iters=max_iters * 3, seed=100 + gi,
            chunks=chunks, params0=p0, device=dev)
        t_actual += t1
        t_full += t2
        accs.append(rand_index(labels, labels_f, k, k))
        iters_es.append(it1)
        iters_fu.append(it2)
    rep = report(t_actual, t_full, time_train_s=t_train, instance=instance)
    return {
        "k": k, "algorithm": algorithm, "mode": "full",
        "device": str(dev), "desired_accuracy": desired_accuracy,
        "achieved_accuracy": float(np.mean(accs)),
        "accuracy_per_group": accs, "h_star": h_star,
        "iters_earlystop_per_group": iters_es,
        "iters_full_per_group": iters_fu,
        "iters_earlystop": sum(iters_es), "iters_full": sum(iters_fu),
        "time_actual_s": t_actual, "time_full_s": t_full,
        "time_train_s": t_train,
        "cost_effectiveness": rep.cost_effectiveness,
        "savings_usd": rep.savings_usd,
        "regression": json.loads(model.to_json()),
        "model": model,
    }


# flags of the reference CLI that later slices port (ROADMAP.md, "Queue for
# the next slices"); each is refused here with a pointer, not ignored
_LATER = {
    "restarts": (1, "--restarts: multi-restart fits are step 1"),
    "mode": ("full", "--mode minibatch: minibatch mode is step 2"),
    "shard": (False, "--shard: distributed fits are step 3"),
    "save_artifact": (None, "--save-artifact: ClusterArtifact is step 1"),
    "stats_compression": ("none", "--stats-compression: step 3"),
    "prefetch": (False, "--prefetch: part of minibatch mode, step 2"),
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="skin",
                    choices=["road3d", "skin", "poker", "spacenet"])
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--algorithm", default="kmeans", choices=["kmeans", "em"])
    ap.add_argument("--desired-accuracy", type=float, default=0.99)
    ap.add_argument("--n", type=int, default=60_000)
    ap.add_argument("--group-size", type=int, default=10_000)
    ap.add_argument("--train-groups", type=int, default=4)
    ap.add_argument("--prod-groups", type=int, default=2)
    ap.add_argument("--max-iters", type=int, default=300)
    ap.add_argument("--family", default="quadratic",
                    help="'auto' runs the paper's model-selection comparison")
    ap.add_argument("--chunks", type=int, default=1,
                    help="stream each sweep over C static row slices")
    ap.add_argument("--instance", default="m5.large")
    ap.add_argument("--save-model", default=None, metavar="PATH",
                    help="write the fitted LongTailModel JSON to PATH")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the hand-written kernels; cpu their "
                         "plain PyTorch versions")
    ap.add_argument("--restarts", type=int, default=1)
    ap.add_argument("--mode", default="full", choices=["full", "minibatch"])
    ap.add_argument("--shard", action="store_true")
    ap.add_argument("--save-artifact", default=None, metavar="PATH")
    ap.add_argument("--stats-compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--prefetch", action="store_true")
    args = ap.parse_args(argv)
    for name, (default, what) in _LATER.items():
        if getattr(args, name) != default:
            ap.error(f"{what} of the port's queue in ROADMAP.md; this slice "
                     "runs full-batch mode, one restart, one device")

    n_prod = max(args.prod_groups, 1)
    if args.dataset == "spacenet":
        groups = spacenet_pixels(n_images=args.train_groups + n_prod,
                                 k_true=args.k)
    else:
        data = load_data(args.dataset, n=args.n)
        groups = random_groups(data, args.group_size,
                               max_groups=args.train_groups + n_prod)
    train_g, prod_g = groups[:args.train_groups], groups[args.train_groups:]
    family = None if args.family == "auto" else args.family
    out = run_pipeline(train_g, prod_g, k=args.k, algorithm=args.algorithm,
                       desired_accuracy=args.desired_accuracy,
                       max_iters=args.max_iters, family=family,
                       chunks=args.chunks, instance=args.instance,
                       device=args.device)
    model = out.pop("model")
    print(f"regression ({model.regression.family}): "
          f"coeffs={[round(c, 6) for c in model.regression.coeffs]} "
          f"R²={model.regression.metrics.r2:.4f}")
    print(f"h*({args.desired_accuracy}) = {out['h_star']:.3e}   "
          f"(training took {out['time_train_s']:.2f}s, amortised — Eq. 9)")
    if args.save_model:
        with open(args.save_model, "w") as f:
            f.write(model.to_json() + "\n")
        print(f"saved LongTailModel → {args.save_model}")
    print(f"early-stop: {out['iters_earlystop_per_group']} iters "
          f"{out['time_actual_s']:.3f}s | full: "
          f"{out['iters_full_per_group']} iters {out['time_full_s']:.3f}s | "
          f"achieved accuracy {out['achieved_accuracy']:.4f} (per group: "
          f"{[round(a, 3) for a in out['accuracy_per_group']]})")
    print(f"cost-effectiveness (Eq.10) = {out['cost_effectiveness']:.3f}  "
          f"savings = ${out['savings_usd']:.6f} on {args.instance} "
          f"[{out['device']}]")
    out["dataset"] = args.dataset
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
