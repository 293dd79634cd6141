"""The readings a cell's limits are set from, on the card at the cell's
own size: the program against the reference on many seeds (the lower
readings), and the control and the planted faults against the reference
on a few (the upper ones). The benchmark's runs never run this.

    python bench_port/calibrate.py --workload <cell> --seeds 11,12,13 --controls 3

Train cells: for each seed the program's first three steps (the timed
path's set-up, `train_cell.first_steps`) against the float32 reference;
for the first `--controls` seeds also the reference in bfloat16 put in the
program's place (the control) and the reference on half of each batch,
the mean over the rest (a planted fault). Serve cells: for the first
`--controls` seeds, the judged requests of a window of `--seconds` at the
mix's rate generated by the reference in bfloat16, against float32 (the
control); the program's own readings come from the cell's runs.
Prints one JSON line a reading.
"""

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def delta_leaf_gap(prog: dict, refr: dict) -> float:
    """The change compared by the worst leaf (the gap of a leaf's norms
    over the larger of the reference's norm of it and of the median
    leaf): the form `gaps` left for the whole change, read for PERF.md."""
    import statistics

    dmed = statistics.median(refr["delta"].values())
    return max(abs(prog["delta"][n] - v) / max(v, dmed) for n, v in refr["delta"].items())


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from bench_port import common

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = common.benchmark()
    wl = common.workload(bench, args.workload)
    cfgfile = common.config_file(bench, wl["config"])
    mix = common.traffic_file(wl["traffic"])
    device = torch.device(args.device)
    seeds = [int(s) for s in args.seeds.split(",")]
    say = lambda **kw: print(json.dumps(kw), flush=True)

    if mix["kind"] == "train":
        from bench_port import train_cell as cell

        mesh, raw_of = cell.meshes(cfgfile, cell.program_config(cfgfile, mix, 0, wl["name"]))
        raw = raw_of()
        for k, seed in enumerate(seeds):
            _, t, (sg, sd) = cell.setup_program(cfgfile, mix, seed, wl["name"], device, mesh)
            prog = cell.first_steps(t, sg, sd)
            del t, sg, sd
            gc.collect()
            torch.cuda.empty_cache()
            refr = cell.reference_steps(cfgfile, mix, seed, device, raw)
            say(seed=seed, reading="program", **cell.gaps(prog, refr),
                delta_leaf_gap=delta_leaf_gap(prog, refr))
            if k < args.controls:
                ctrl = cell.reference_steps(cfgfile, mix, seed, device, raw, dtype=torch.bfloat16)
                say(seed=seed, reading="control_bf16", **cell.gaps(ctrl, refr),
                    delta_leaf_gap=delta_leaf_gap(ctrl, refr))
                half = cell.reference_steps(cfgfile, mix, seed, device, raw,
                                            rows_used=mix["batch_size"] // 2)
                say(seed=seed, reading="fault_half_batch", **cell.gaps(half, refr),
                    delta_leaf_gap=delta_leaf_gap(half, refr))
    else:
        from bench_port import serve_cell as cell
        from bench_port import weights
        from bench_port.reference import model as ref
        from bench_port.reference.mesh import RefMesh, load_raw

        gen = common.generator(mix["kind"])
        raw = load_raw(cell.ASSETS)
        mesh = RefMesh(raw, device)
        s = cfgfile["settings"]
        for seed in seeds[: args.controls]:
            reqs = gen.requests(mix, seed, args.seconds, stream=1)
            keep = gen.judged(mix, seed, reqs)
            P = weights.make(ref.param_spec(s, mesh.level_sizes, mesh.level_sizes_d), seed, device)
            served = {}
            with torch.no_grad():
                for i in keep:
                    r = reqs[i]
                    z = torch.as_tensor(gen.latents(r, s["nz"]), device=device)
                    pose = torch.as_tensor(r["pose"], device=device).expand(r["n"], -1)
                    clo = torch.as_tensor(r["clo"], device=device).expand(r["n"], -1)
                    served[i] = ref.sample_mesh(s, P, mesh, z, pose, clo,
                                                torch.bfloat16).float().cpu().numpy()
            gap = cell.reference_gap(cfgfile, mix, seed, reqs, served, device, raw)
            say(seed=seed, reading="control_bf16", mesh_gap=gap, meshes=sum(reqs[i]["n"] for i in keep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
