"""The paper's headline workload as a SERVICE, on the PyTorch port: many
small clients, one device, one coalescing dispatcher -- in-process AND over
the network.

The paper evaluates 0.5M independent HVPs as one pre-built batch (§7); a
real serving deployment receives them as single-point requests from many
concurrent clients.  This example spawns ``--clients`` threads that share
``--requests`` single HVP requests through ``CurvatureService.submit`` --
the service coalesces whatever is in flight into padded power-of-two
micro-batches and executes them with the engine's cached batched
callables (on the card, a dense bucket of a test function is one
``chess_hvp`` launch).  Compare against ``--no-service``
(one-request-at-a-time plan.hvp calls) to see the coalescing win.

After the in-process demo, the same service is exposed through the TCP
front-end (``repro_torch.serving.frontend``, line-delimited JSON): two
socket clients fire MIXED-``n`` requests at a ``RaggedFamily`` plan, and the
scheduler coalesces the different row widths into shared ragged buckets
(watch ``ragged_batches`` in the printed stats).  Skip with
``--no-frontend``.

    PYTHONPATH=src python examples_torch/hvp_service.py --n 16 --clients 8 \
        --requests 256 --function ackley --backend auto --csize auto
    PYTHONPATH=src python examples_torch/hvp_service.py --max-wait-us 1000
    PYTHONPATH=src python examples_torch/hvp_service.py --no-service
    PYTHONPATH=src python examples_torch/hvp_service.py --device cpu
"""

import argparse
import threading
import time

import numpy as np
import torch

from repro_torch import engine
from repro_torch.core import testfns


def _host(x):
    """A result as a host float32 array (service futures already are)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _synced(plan, fn):
    """``fn`` followed by a wait for the plan's device, so that the clock
    read after it covers the device work."""
    if plan.device.type != "cuda":
        return fn

    def call(*a):
        out = fn(*a)
        torch.cuda.synchronize(plan.device)
        return out
    return call


def run_baseline(plan, A, V):
    """One-request-at-a-time: what serving looks like without coalescing."""
    try:
        plan.backend_for("hvp")
        one = lambda i: plan.hvp(A[i], V[i])
    except ValueError:
        # batched-only backends (cuda serves just batched_hvp) still get a
        # sequential baseline: one-row batches, one request at a time
        one = lambda i: plan.batched_hvp(A[i:i + 1], V[i:i + 1])[0]
    one = _synced(plan, one)
    one(0)                                               # build + warmup
    t0 = time.perf_counter()
    outs = [one(i) for i in range(A.shape[0])]
    return outs, time.perf_counter() - t0


def warm_buckets(plan, A, V, max_batch):
    """Build the bucket callables (and the kernel) up front: steady-state
    serving never builds, so the demo times dispatch, not set-up.  Warms
    through bucket_size(min(requests, max_batch)) because partial batches
    pad UP to the next power of two."""
    top = engine.bucket_size(min(max_batch, A.shape[0]), max_batch)
    run = _synced(plan, plan.batched_hvp)
    b = 1
    while b <= top:
        k = min(b, A.shape[0])
        run(engine.pad_rows(A[:k], b), engine.pad_rows(V[:k], b))
        b *= 2


def run_service(plan, A, V, clients, max_batch, max_wait_us):
    """Many client threads submitting singles; one coalescing dispatcher."""
    total = A.shape[0]
    warm_buckets(plan, A, V, max_batch)
    results = [None] * total
    svc = engine.CurvatureService(max_batch=max_batch,
                                  max_wait_us=max_wait_us)

    def client(cid):
        futs = [(i, svc.submit(plan, A[i], V[i]))
                for i in range(cid, total, clients)]
        for i, fut in futs:
            results[i] = fut.result()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    stats = svc.stats()
    svc.shutdown()
    return results, dt, stats


def run_frontend(args, device):
    """The same service behind the network front-end, with mixed-n clients.

    Shape-polymorphic functions are served as a RaggedFamily, so the two
    clients' different row widths coalesce into shared ragged buckets.
    Returns the demo's figures (None when skipped)."""
    from repro_torch.serving.frontend import CurvatureFrontend, connect
    if args.function == "fletcher_powell":
        print("  frontend demo: fletcher_powell has per-n coefficients "
              "(no ragged family); skipping")
        return None
    fam = testfns.ragged_family(args.function)
    plans = {args.function: lambda n: engine.plan(fam, n, symmetric=False,
                                                  device=device)}
    ns = sorted({args.n, max(4, args.n // 2), args.n + args.n // 4})
    rng = np.random.RandomState(1)
    per_client = 32
    with CurvatureFrontend(plans, max_batch=args.max_batch,
                           max_wait_us=max(args.max_wait_us, 500.0)) as fe:
        host, port = fe.address
        print(f"  frontend on {host}:{port} serving {sorted(plans)} "
              f"at n in {ns}")
        errs, scales = [], []

        def client(cid):
            with connect(host, port, client=f"client-{cid}") as cli:
                futs = []
                for i in range(per_client):
                    n = ns[(cid + i) % len(ns)]
                    a = rng.uniform(-2, 2, n).astype(np.float32)
                    v = rng.uniform(-1, 1, n).astype(np.float32)
                    futs.append((n, a, v,
                                 cli.submit_hvp(args.function, a, v)))
                for n, a, v, fut in futs:
                    got = np.asarray(fut.result(timeout=60), np.float32)
                    want = _host(engine.plan(fam, n, symmetric=False,
                                             device=device).hvp(a, v))
                    errs.append(float(np.max(np.abs(got - want))))
                    scales.append(float(np.max(np.abs(want))))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
        stats = fe.service.stats()
        total = 2 * per_client
        print(f"  {total} socket round-trips in {dt * 1e3:.1f} ms "
              f"({total / dt:,.0f} req/s) -- {stats['batches']} batches, "
              f"{stats['ragged_batches']} ragged (cross-n), max |err| = "
              f"{max(errs):.2e}")
        clients = engine.client_stats()
        print(f"  per-client telemetry: {clients}")
    return {"ns": ns, "round_trips": len(errs), "s": dt,
            "req_per_s": total / dt, "batches": stats["batches"],
            "ragged_batches": stats["ragged_batches"],
            "max_abs_err": max(errs), "max_abs_want": max(scales),
            "client_stats": clients}


def main(argv=None):
    """Runs the demo; returns its printed figures, and under ``"arrays"``
    the requests and both sets of results as host arrays."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--function", default="rosenbrock",
                    choices=list(testfns.FUNCTIONS))
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--requests", type=int, default=1024,
                    help="total single-HVP requests across all clients")
    ap.add_argument("--clients", type=int, default=8,
                    help="concurrent client threads")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--max-wait-us", type=float, default=200.0,
                    help="latency budget before a partial bucket flushes")
    ap.add_argument("--csize", default="auto",
                    help="int, 'auto' (§5 model) or 'autotune' (measured)")
    ap.add_argument("--backend", default="auto",
                    help=f"one of: auto, "
                         f"{', '.join(sorted(engine.list_backends()))}")
    ap.add_argument("--no-service", action="store_true",
                    help="sequential one-request-at-a-time baseline only")
    ap.add_argument("--no-frontend", action="store_true",
                    help="skip the network front-end demo")
    ap.add_argument("--device", default="cuda",
                    help="where the plans run (default the card)")
    args = ap.parse_args(argv)
    device = engine.resolve_device(args.device)

    n, total = args.n, args.requests
    csize = args.csize if args.csize in ("auto", "autotune") \
        else int(args.csize)
    if args.function == "fletcher_powell":
        # its coefficients on the plan's device, not copied every call
        f = testfns.make_fletcher_powell(n, device=device)
    else:
        f = testfns.FUNCTIONS[args.function](n)
    rng = np.random.RandomState(0)
    # host arrays: serving payloads arrive as host data, and the service
    # marshals each bucket to the device as one array
    A = np.asarray(rng.uniform(-2, 2, (total, n)), np.float32)
    V = np.asarray(rng.randn(total, n), np.float32)

    plan = engine.plan(f, n, m=total, csize=csize, backend=args.backend,
                       symmetric=False, device=device)
    backend = plan.backend_for("batched_hvp")
    print(f"{args.function} n={n} requests={total} csize={plan.csize} "
          f"backend={backend}")
    out = {"function": args.function, "n": n, "requests": total,
           "csize": plan.csize, "backend": backend, "device": str(device)}

    base_out, base_dt = run_baseline(plan, A, V)
    base_rps = total / base_dt
    base_out = [_host(b) for b in base_out]
    out.update(baseline_s=base_dt, baseline_req_per_s=base_rps,
               arrays={"A": A, "V": V, "baseline": np.stack(base_out)})
    print(f"  baseline (sequential plan.hvp): {base_dt * 1e3:.1f} ms, "
          f"{base_rps:,.0f} req/s")
    if args.no_service:
        return out

    svc_out, svc_dt, stats = run_service(plan, A, V, args.clients,
                                         args.max_batch, args.max_wait_us)
    svc_rps = total / svc_dt
    err = max(float(np.abs(s - b).max())
              for s, b in zip(svc_out, base_out))
    buckets = ", ".join(f"{b}x{c}" for b, c in sorted(stats["buckets"].items()))
    print(f"  service ({args.clients} clients, max_batch={args.max_batch}, "
          f"max_wait_us={args.max_wait_us:g}): {svc_dt * 1e3:.1f} ms, "
          f"{svc_rps:,.0f} req/s -- {svc_rps / base_rps:.1f}x")
    print(f"  {stats['batches']} micro-batches (bucket x count: {buckets}), "
          f"{stats['padded_rows']} padded rows, max |serve - direct| = "
          f"{err:.2e}")
    telemetry = {}
    for rec in engine.execution_stats():
        per_bucket = {b: round(v["us_per_point_mean"], 1)
                      for b, v in rec["by_bucket"].items()}
        telemetry[f"{rec['backend']}/{rec['workload']}"] = per_bucket
        print(f"  telemetry [{rec['backend']}/{rec['workload']}] "
              f"us/point by bucket: {per_bucket}")
    out.update(service_s=svc_dt, service_req_per_s=svc_rps,
               speedup=svc_rps / base_rps, batches=stats["batches"],
               buckets={str(b): c for b, c in sorted(stats["buckets"].items())},
               padded_rows=stats["padded_rows"], max_abs_err=err,
               us_per_point_by_bucket=telemetry)
    out["arrays"]["served"] = np.stack([_host(s) for s in svc_out])
    if not args.no_frontend:
        out["frontend"] = run_frontend(args, device)
    return out


if __name__ == "__main__":
    main()
