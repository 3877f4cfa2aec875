"""Find a serving cell's knee: the highest Poisson rate at which the 95th
percentile of clip latency stays under a limit with no growing backlog.

    python3 portbench/sweep_serve.py --workload serve-poisson --seed <n> --seconds 30 --rates 10 12 14 16

One process builds the cell's model and server once, then offers each rate
for `--seconds` through the serve driver's open loop and prints one JSON
line a rate: p50, p95 and the largest latency, the requests completed a
second, and the backlog's growth (the mean latency of the last quarter of
the requests over the first quarter's). The cell's traffic file then holds
0.8 of the knee as a number; the benchmark never searches for a rate."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="serve-poisson")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--limit-s", type=float, default=2.0)
    args = ap.parse_args(argv)

    import run  # portbench/run.py, beside this file
    import torch
    from phenaki_tpu_torch.serving import PhenakiServer

    from portbench import build, inputs
    from portbench.common import percentile, subseed
    from portbench.drivers.common import setup_torch
    from portbench.drivers.serve import open_loop

    spec = run.cell_spec(args.workload, args.seed, args.seconds, False)
    setup_torch(spec)
    s = spec.config["sampling"]
    ph, _, _ = build.build(spec.config, subseed(args.seed, 1), "cuda", "sample")
    server = PhenakiServer(ph, num_frames=s["num_frames"], seed=subseed(args.seed, 2) % 2**63)
    server.prewarm()
    for k, rate in enumerate(args.rates):
        due = inputs.arrivals(subseed(args.seed, 10, k), rate, args.seconds)
        pool = inputs.text_embeds(subseed(args.seed, 11, k), len(due), text_dim=s["text_dim"],
                                  max_text_len=s["max_text_len"], text_len=spec.traffic["text_len"],
                                  device="cuda")
        lengths = (pool != 0).any(-1).sum(-1).tolist()
        host = pool.cpu().numpy()
        client = [host[i, :lengths[i]] for i in range(len(due))]
        launches0 = len(server.launch_log)
        t0 = time.perf_counter()
        latency, lag, results, shed = open_loop(server, due, client, args.seconds)
        wall = time.perf_counter() - t0
        q = max(1, len(latency) // 4)
        first, last = sum(latency[:q]) / q, sum(latency[-q:]) / q
        log = server.launch_log[launches0:]
        print(json.dumps({
            "rate": rate, "requests": len(due), "p50_s": percentile(latency, 50),
            "p95_s": percentile(latency, 95), "max_s": max(latency), "completed_per_s":
            sum(r is not None for r in results) / wall, "backlog_growth": last / first,
            "shed": sum(shed), "lag_p95_ms": percentile(lag, 95), "launches": len(log),
            "fill": sum(n for n, _ in log) / max(1, sum(b for _, b in log)),
            "under_limit": percentile(latency, 95) < args.limit_s,
            "card": torch.cuda.get_device_name(0)}), flush=True)
        del pool, host, client, results
    server.close()


if __name__ == "__main__":
    main()
