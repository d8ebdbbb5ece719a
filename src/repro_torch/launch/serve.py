"""Curvature server entrypoint: the network-facing HVP/Hessian service.

Counterpart of ``repro.launch.serve``.  Brings up the full serving stack --
TCP front-end over admission + scheduler + dispatch -- serving the paper's
test functions by name, on one device.  The shape-polymorphic functions
(rosenbrock, ackley) are served as ``RaggedFamily`` plans, so mixed-``n``
HVP requests from different clients coalesce into shared ragged buckets;
fletcher_powell builds one plan per requested ``n``.  On the card, every
dense HVP bucket of the three functions runs the hand-written ``chess_hvp``
kernel (backend ``cuda``); mixed-``n`` buckets run the ragged
``torch.func`` path, as the reference runs ``vmap`` there.

  # serve on the card until interrupted:
  python -m repro_torch.launch.serve --port 7311 --high-water 2048

  # on the CPU (the default device is cuda; without a card the server
  # exits non-zero unless --device cpu is given):
  python -m repro_torch.launch.serve --device cpu --port 7311

  # with the tcmalloc preload (re-execs once with the env applied):
  python -m repro_torch.launch.serve --tuned-env apply --port 7311

  # Prometheus /metrics + /trace on a sidecar HTTP port:
  python -m repro_torch.launch.serve --port 7311 --metrics-port 9100

  # end-to-end selftest (ephemeral port, client round-trips, exit code):
  python -m repro_torch.launch.serve --device cpu --selftest
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from repro_torch import engine, obs
from repro_torch.core import testfns
from repro_torch.serving.frontend import CurvatureFrontend, connect

_TCMALLOC_CANDIDATES = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
)


def tuned_env() -> dict:
    """The host-level tuned launch environment: the tcmalloc preload.

    Returns only the variables that are MISSING from the current
    environment, and nothing when tcmalloc is not installed.  The
    reference's XLA_FLAGS (host device count) and TF_CPP_MIN_LOG_LEVEL
    have no PyTorch counterpart and are not set."""
    want = {}
    lib = next((c for c in _TCMALLOC_CANDIDATES if os.path.exists(c)), None)
    if lib is not None and lib not in os.environ.get("LD_PRELOAD", ""):
        pre = os.environ.get("LD_PRELOAD")
        want["LD_PRELOAD"] = f"{lib}:{pre}" if pre else lib
        want["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] = "60000000000"
    return want


def apply_tuned_env() -> None:
    """Re-exec this process once with the tuned env applied.

    LD_PRELOAD only takes effect at process start, so "apply" means exec,
    not os.environ mutation.  A guard variable prevents a re-exec loop."""
    if os.environ.get("_REPRO_TUNED_ENV") == "1":
        return
    want = tuned_env()
    env = dict(os.environ)
    env.update(want)
    env["_REPRO_TUNED_ENV"] = "1"
    if want:
        print("tuned-env: applying "
              + " ".join(f"{k}={v}" for k, v in sorted(want.items())),
              flush=True)
    argv, skip = [], False
    for a in sys.argv[1:]:
        if skip:
            skip = False
            continue
        if a == "--tuned-env":
            skip = True        # also drop its separate value token
            continue
        if a.startswith("--tuned-env="):
            continue
        argv.append(a)
    os.execve(sys.executable, [sys.executable, "-m",
                               "repro_torch.launch.serve", *argv], env)


def build_plans(functions, symmetric: bool = False, device="cuda") -> dict:
    """Name -> plan factory registry for the front-end; every plan is on
    ``device`` (a CUDA device without an index is the current one)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    plans = {}
    for name in functions:
        if name in ("rosenbrock", "ackley"):
            fam = testfns.ragged_family(name)
            plans[name] = (lambda n, _fam=fam: engine.plan(
                _fam, n, symmetric=symmetric, device=device))
        elif name == "fletcher_powell":
            plans[name] = lambda n: engine.plan(
                testfns.make_fletcher_powell(n, device=device), n,
                symmetric=symmetric, device=device)
        else:
            raise SystemExit(f"unknown function {name!r}; expected a subset "
                             f"of {sorted(testfns.FUNCTIONS)}")
    return plans


def build_admission(args) -> engine.AdmissionController | None:
    if args.high_water is None and args.rate is None:
        return None
    return engine.AdmissionController(
        default_policy=engine.ClientPolicy(rate=args.rate, burst=args.burst),
        high_water=args.high_water,
        interactive_headroom=args.interactive_headroom)


def selftest(fe: CurvatureFrontend, device) -> int:
    """Round-trip mixed-n HVPs from two clients; verify against plan.hvp."""
    host, port = fe.address
    rng = np.random.RandomState(0)
    checks = []
    with connect(host, port, client="selftest-a") as ca, \
            connect(host, port, client="selftest-b") as cb:
        if ca.ping() != "pong":
            print("FAIL ping")
            return 1
        print(f"plans: {ca.plans()}")
        futs = []
        for i, (cli, n) in enumerate([(ca, 8), (cb, 12), (ca, 16),
                                      (cb, 8), (ca, 12), (cb, 16)]):
            a = rng.uniform(-2, 2, n).astype(np.float32)
            v = rng.uniform(-1, 1, n).astype(np.float32)
            pr = "interactive" if i % 3 == 0 else "batch"
            futs.append((n, a, v, cli.submit_hvp("rosenbrock", a, v,
                                                 priority=pr)))
        for n, a, v, fut in futs:
            got = np.asarray(fut.result(timeout=60), np.float32)
            want = engine.plan(testfns.ragged_family("rosenbrock"), n,
                               symmetric=False,
                               device=device).hvp(a, v).cpu().numpy()
            rel = float(np.max(np.abs(got - want))
                        / (np.max(np.abs(want)) + 1e-8))
            checks.append(rel)
            if rel > 1e-3:
                print(f"FAIL n={n} relerr={rel:.2e}")
                return 1
        stats = ca.stats()
    print(f"selftest: {len(checks)} round-trips OK "
          f"(max relerr {max(checks):.2e}); "
          f"batches={stats['batches']} ragged={stats['ragged_batches']} "
          f"clients={sorted(engine.client_stats())}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="network-facing curvature (HVP/Hessian) server")
    ap.add_argument("--device", default="cuda",
                    help="where every plan runs (default cuda; without a "
                         "CUDA card the server exits unless --device cpu)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 binds an ephemeral port (printed at startup)")
    ap.add_argument("--functions", default="rosenbrock,ackley",
                    help="comma list served by name over the wire")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-us", type=float, default=500.0)
    ap.add_argument("--max-queue", type=int, default=4096)
    ap.add_argument("--workers", type=int, default=None,
                    help="dispatch workers (default: one per visible CUDA "
                         "device, or one)")
    ap.add_argument("--no-cross-n", action="store_true",
                    help="disable cross-n ragged coalescing")
    ap.add_argument("--coalesce-waste-max", type=float, default=0.4)
    ap.add_argument("--high-water", type=int, default=None,
                    help="queue depth where batch submits start shedding")
    ap.add_argument("--interactive-headroom", type=float, default=1.5)
    ap.add_argument("--rate", type=float, default=None,
                    help="per-client token-bucket refill (req/s)")
    ap.add_argument("--burst", type=int, default=32)
    ap.add_argument("--retune-interval-s", type=float, default=None,
                    help="the online re-tune thread: refused until its "
                         "default tuner is ported (ROADMAP A.2, \"Tuning\")")
    ap.add_argument("--tuned-env", choices=("print", "apply"), default=None,
                    help="host-level tuned environment, the tcmalloc "
                         "preload: 'print' emits export lines and exits, "
                         "'apply' re-execs the server with it in effect.  "
                         "The reference's XLA_FLAGS and "
                         "TF_CPP_MIN_LOG_LEVEL have no PyTorch counterpart "
                         "and are not set")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus /metrics, /metrics.json and "
                         "/trace on this sidecar HTTP port (0 = ephemeral)")
    ap.add_argument("--no-obs", action="store_true",
                    help="disable the observability subsystem (tracing + "
                         "metrics)")
    ap.add_argument("--trace-buffer", type=int, default=256,
                    help="flight-recorder capacity (finished traces kept)")
    ap.add_argument("--slow-ms", type=float, default=100.0,
                    help="slow-request threshold: traces at least this "
                         "long are pinned in the slow ring")
    ap.add_argument("--selftest", action="store_true",
                    help="serve on an ephemeral port, run client "
                         "round-trips, exit")
    args = ap.parse_args(argv)

    if args.tuned_env == "print":
        for k, v in sorted(tuned_env().items()):
            print(f"export {k}='{v}'")
        return 0
    if args.retune_interval_s is not None:
        ap.error("--retune-interval-s: the online re-tune has no default "
                 "tuner until ROADMAP A.2 (\"Tuning\") ports it")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("serve: no CUDA device is available; pass --device cpu to "
              "serve on the CPU", file=sys.stderr)
        return 2
    if args.tuned_env == "apply":
        apply_tuned_env()       # no return on the exec path

    if args.no_obs:
        obs.disable()
    else:
        from repro_torch.obs import trace as _obs_trace
        _obs_trace._replace_default(obs.FlightRecorder(
            capacity=args.trace_buffer,
            slow_threshold_s=args.slow_ms * 1e-3))

    plans = build_plans([f.strip() for f in args.functions.split(",")
                         if f.strip()], device=device)
    svc = engine.CurvatureService(
        max_batch=args.max_batch, max_wait_us=args.max_wait_us,
        max_queue=args.max_queue, workers=args.workers,
        admission=build_admission(args),
        coalesce_across_n=not args.no_cross_n,
        coalesce_waste_max=args.coalesce_waste_max)
    fe = CurvatureFrontend(plans, service=svc, host=args.host,
                           port=args.port)
    fe.start()
    host, port = fe.address
    print(f"curvature server on {host}:{port} "
          f"(device {device}; functions: {sorted(plans)}; cross-n "
          f"{'off' if args.no_cross_n else 'on'}; obs "
          f"{'off' if args.no_obs else 'on'})", flush=True)
    metrics_srv = None
    if args.metrics_port is not None:
        from repro_torch.obs.http import start_metrics_server
        metrics_srv = start_metrics_server(args.host, args.metrics_port)
        print(f"metrics on http://{args.host}:{metrics_srv.port}/metrics "
              f"(/metrics.json, /trace)", flush=True)
    try:
        if args.selftest:
            return selftest(fe, device)
        while True:
            time.sleep(10.0)
            s = svc.stats()
            print(f"  served={s['dispatched']} batches={s['batches']} "
                  f"ragged={s['ragged_batches']} pending={s['pending']}",
                  flush=True)
    except KeyboardInterrupt:
        print("shutting down")
        return 0
    finally:
        if metrics_srv is not None:
            metrics_srv.close()
        fe.stop()
        svc.shutdown(wait=True)


if __name__ == "__main__":
    sys.exit(main())
