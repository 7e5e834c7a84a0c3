"""Run every reference scenario family end-to-end and print metrics.

Usage:
    python scenarios/run_all.py [--quick] [--family NAME] [--plot] [--device]

Families: diffdrive, circular, lti, ltv, dynamic, frenet (default: all).
Runs on host CPU (x64) by default for full precision; --device runs on JAX's
default device (the GPU where there is one) in f32.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

# script lives in scenarios/; make the repo root importable
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="short closed loops")
    ap.add_argument("--family", default="all")
    ap.add_argument("--plot", action="store_true", help="write dashboards to ./plots")
    ap.add_argument("--device", action="store_true",
                    help="run on the default device instead of the host CPU")
    args = ap.parse_args()

    if not args.device:
        from mpc_verde_tpu.utils import force_cpu

        force_cpu()
        import jax

        jax.config.update("jax_enable_x64", True)

    from mpc_verde_tpu import scenarios as sc

    n = 120 if args.quick else None
    # lane-change families: the synthetic maneuver spans samples 125-375 of
    # the 500-sample course, so the quick window must cover it or the error
    # metrics only measure the straight lead-in
    nlc = 400 if args.quick else None
    fams = {
        "diffdrive": lambda: sc.run_diffdrive(sc.build_diffdrive(n_steps=min(n or 100, 100))),
        "circular": lambda: sc.run_circular_tracking(sc.build_circular_tracking(n_steps=n)),
        "lti": lambda: sc.run_lane_change_lti(sc.build_lane_change_lti(n_steps=nlc)),
        "ltv": lambda: sc.run_lane_change_ltv(sc.build_lane_change_ltv(n_steps=nlc)),
        "dynamic": lambda: sc.run_dynamic_bicycle(sc.build_dynamic_bicycle(n_steps=nlc)),
        "frenet": lambda: sc.run_frenet(sc.build_frenet(n_steps=nlc)),
        "pendulum": lambda: sc.run_pendulum(sc.build_pendulum(n_steps=min(n or 1000, 1000))),
        "curvature": lambda: sc.run_curvature_ltv(sc.build_curvature_ltv(n_steps=nlc)),
        "fleet": lambda: sc.run_fleet(sc.build_fleet(
            B=64 if args.quick else 1024, n_steps=n)),
    }
    picks = fams if args.family == "all" else {args.family: fams[args.family]}

    failures = 0
    for name, fn in picks.items():
        t0 = time.time()
        try:
            m = fn()
            metrics = {k: v for k, v in m.items()
                       if isinstance(v, (int, float, bool))}
            metrics["wall_s"] = round(time.time() - t0, 1)
            print(json.dumps({"family": name, **metrics}))
        except Exception as e:  # pragma: no cover
            failures += 1
            print(json.dumps({"family": name, "error": repr(e)}))
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
