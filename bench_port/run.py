"""Run one cell of the port's benchmark once.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's traffic mix names its kind, and
`bench_port/<kind>_cell.py` drives it. With --trace 0 the result line
carries the cell's end-to-end metrics, with --trace 1 its per-layer ones.
Needs as many CUDA cards as the cell asks for: without them it exits 3
and prints no result. It exits 4, with no result, if JAX or the JAX
package is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# device presence through NVML, so that the check opens no CUDA context
# (the serve cell's server process is the card's one user)
os.environ.setdefault("PYTORCH_NVML_BASED_CUDA_CHECK", "1")


def parse(argv=None):
    p = argparse.ArgumentParser(prog="bench_port/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from bench_port import common

    bench = common.benchmark()
    wl = common.workload(bench, args.workload)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(common.WORK_DIR, sub)
    mix = common.traffic_file(wl["traffic"])
    # a serve run is the load generator; its server process pins itself
    common.pin(common.CLIENT_CORES if mix["kind"] == "serve" else common.PROGRAM_CORES)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    cell = importlib.import_module(f"bench_port.{mix['kind']}_cell")
    result, checks = cell.run(args, T0, bench, wl, common.config_file(bench, wl["config"]), mix)
    found = common.forbidden_modules() + result.pop("forbidden", [])
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 4
    common.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
