"""Find a serve cell's knee: one server process, the cell's traffic at
each of several fixed rates, each rate's p50 and p95 latency, the meshes
answered a second, and whether a backlog grew (the median latency of the
stretch's last quarter of requests over its first quarter's).

    python bench_port/sweep.py --workload <serve cell> --seed <n> --seconds 10 \\
        --rates 40,80,120

The knee is the highest rate whose p95 stays within the limit the cell's
mix was chosen for, with no growing backlog. Prints one JSON line a rate.
"""

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", required=True, help="comma-separated requests a second")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from bench_port import common, serve_cell

    common.pin(common.CLIENT_CORES)
    bench = common.benchmark()
    wl = common.workload(bench, args.workload)
    mix = common.traffic_file(wl["traffic"])
    gen = common.generator(mix["kind"])
    child = serve_cell.Child(args.workload, args.seed, args.device)
    try:
        for k, rate in enumerate(float(r) for r in args.rates.split(",")):
            m = {**mix, "rate": rate}
            warm = gen.requests(m, args.seed, 2.0, stream=10 + 2 * k)
            serve_cell.open_loop(child.port, warm, [gen.body(r) for r in warm], child.num_verts,
                                 set(), m["tail_seconds"])
            reqs = gen.requests(m, args.seed, args.seconds, stream=11 + 2 * k)
            out = serve_cell.open_loop(child.port, reqs, [gen.body(r) for r in reqs],
                                       child.num_verts, set(), m["tail_seconds"])
            s = serve_cell.summary(reqs, out, args.seconds)
            q = max(1, len(reqs) // 4)
            first = statistics.median(out["lat"][:q])
            last = statistics.median(out["lat"][-q:])
            print(json.dumps({"rate": rate, "requests": len(reqs), **s,
                              "backlog_ratio": last / first}), flush=True)
    finally:
        child.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
