"""Serve a small LM with batched requests through the continuous-batching
engine (slot reuse, per-slot positions, greedy/temperature sampling), on
the PyTorch port.

    PYTHONPATH=src python examples_torch/serve_lm.py --requests 12 \
        --max-batch 4
    PYTHONPATH=src python examples_torch/serve_lm.py --device cpu
"""

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.engine import resolve_device
from repro_torch.models.decode_engine import ServingEngine
from repro_torch.models.params import init_params


def main(argv=None):
    """Serves the requests; returns the printed figures."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="where the model and its caches live (default the "
                         "card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch, reduced=True)
    params = init_params(cfg, 0, device=device)
    eng = ServingEngine(params, cfg, max_batch=args.max_batch, max_seq=256,
                        temperature=args.temperature, device=device)

    rng = np.random.RandomState(0)
    for _ in range(args.requests):
        plen = int(rng.randint(4, 48))
        eng.submit(rng.randint(0, cfg.vocab_size, size=plen),
                   max_new_tokens=args.max_new)

    t0 = time.perf_counter()
    done = eng.run()            # its sampled tokens are read on the host
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in done)
    print(f"arch={cfg.name} served {len(done)} requests / {toks} tokens "
          f"in {dt:.2f}s -> {toks / dt:.1f} tok/s "
          f"(max_batch={args.max_batch})")
    for r in done[:3]:
        print(f"  rid={r.rid}: {r.out_tokens}")
    return {"arch": cfg.name, "requests": len(done), "tokens": toks,
            "s": dt, "tokens_per_s": toks / dt, "max_batch": args.max_batch,
            "out_tokens": {r.rid: [int(t) for t in r.out_tokens]
                           for r in done}, "device": str(device)}


if __name__ == "__main__":
    main()
