"""Readings that set a serving cell's limits: for each seed, the numbers
the output check compares on the program's served subjects, and on the
control's (the plain model in the configuration's lower precision put in
the program's place), in one process. The benchmark's own runs do not
run this.

    python3 perfbench/calibrate.py --workload serve_mono-surs_bf16 \
        --seeds 11,12,13 --control-seeds 11,12,13 [--fault NAME]

``--fault`` serves through a planted fault of the timed path instead
(``perfbench/faults.py``). One JSON line a seed and side, with
``correct`` as a run would read it under the cell's limits
(``perfbench/limits/<cell>.json``): the control's rows and a fault's
read false.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def serve_subjects(service, pool, order, n, sink_dir):
    """The first ``n`` subjects of the order through the timed path;
    returns [(image, mask, [hr bytes, lr bytes])]."""
    import numpy as np
    from perfbench import sink as sink_mod
    sink = sink_mod.ObjSink(sink_dir, keep=n, rng=np.random.default_rng(0))
    try:
        names = []
        items = []
        for i in range(n):
            k = int(order[i % len(order)])
            name = f"c{i:03d}"
            sink.plan(name)
            names.append((name, k))
            items.append((pool[k][0], pool[k][1], name))
        service.reconstruct_many(items, sink_dir, stats={})
        sink.wait()
        return [(pool[k][0], pool[k][1], sink.kept[name])
                for name, k in names]
    finally:
        sink.close()


def serve_readings(run, args, tmp, sides, traffic, n):
    from perfbench import faults
    from perfbench.drivers import serve
    from perfbench.reference import serve_check
    check = traffic["check"]
    service, cfg, params = serve.build(run, tmp)
    undo = faults.plant(args.fault) if args.fault else None
    try:
        for side, seeds in sides:
            for seed in [int(s) for s in seeds.split(",") if s]:
                t = time.perf_counter()
                run.seed = seed
                pool, order = serve.make_pool(traffic, seed)
                if side == "program":
                    subjects = serve_subjects(service, pool, order, n,
                                              os.path.join(tmp, f"o{seed}"))
                    res = serve_check.judge(run, cfg, params, subjects,
                                            check, n)
                else:
                    subjects = [(pool[int(k)][0], pool[int(k)][1], None)
                                for k in order[:n]]
                    res = serve_check.judge(
                        run, cfg, params, subjects, check, n,
                        control=(run.config["precision"]["control"]
                                 if side == "control" else "jitter"))
                yield {"side": side, "seed": seed,
                       "numbers": res["numbers"],
                       "widest": res["info"]["field_gap_max"],
                       "p99": res["info"]["field_gap_p99"],
                       "meshes": res["info"]["meshes"],
                       "seconds": time.perf_counter() - t}
    finally:
        if undo is not None:
            undo()


def train_readings(run, args, tmp, sides):
    import torch
    from perfbench import faults
    from perfbench.drivers import train
    from perfbench.reference import train_check
    checked = int(run.traffic["checked_steps"])
    for side, seeds in sides:
        for seed in [int(s) for s in seeds.split(",") if s]:
            t = time.perf_counter()
            run.seed = seed
            d = tempfile.mkdtemp(dir=tmp)
            undo = faults.plant(args.fault) if args.fault else None
            try:
                res = train.train_run(run, d, window=False)
            finally:
                if undo is not None:
                    undo()
            cfg, items, params, got = (res["cfg"], res["items"],
                                       res["params"], res["got"])
            del res
            if run.device.startswith("cuda"):
                torch.cuda.empty_cache()
            batch = train_check.batch_tensors(items[:cfg.batch_size],
                                              torch.device(run.device))
            want = train_check.reference_steps(params, batch, cfg, checked)
            if side != "program":
                got = train_check.reference_steps(
                    params, batch, cfg, checked,
                    mode=(run.config["precision"]["control"]
                          if side == "control" else "jitter"))
            shutil.rmtree(d, ignore_errors=True)
            yield {"side": side, "seed": seed,
                   "numbers": train_check.compare(got, want),
                   "loss": got["loss"], "ref_loss": want["loss"],
                   "worst_grad": train_check.worst_leaves(got, want,
                                                          "grad1"),
                   "worst_change": train_check.worst_leaves(got, want,
                                                            "change"),
                   "seconds": time.perf_counter() - t}


def main(argv=None, overrides=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--subjects", type=int, default=0,
                   help="subjects a seed (default: the mix's check count)")
    p.add_argument("--look-seeds", default="",
                   help="seeds for the diagnostic: the float32 reference "
                   "with each occupancy moved by at most 1e-4 in the "
                   "program's place")
    p.add_argument("--fault", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", action="append", default=[],
                   help="KEY=JSON: a model setting for a diagnostic run")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from perfbench import harness
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    if args.set:
        overrides = json.loads(json.dumps(overrides or {}))
        for kv in args.set:
            k, v = kv.split("=", 1)
            overrides.setdefault("model", {})[k] = json.loads(v)
    run = harness.prepare(bench, args.workload, 0, 0.0, False, T0,
                          args.device, overrides)
    traffic = {**run.traffic, **run.overrides.get("traffic", {})}
    tmp = tempfile.mkdtemp(prefix="perfbench-cal-")
    sides = [("program", args.seeds), ("control", args.control_seeds),
             ("look", args.look_seeds)]
    try:
        if run.traffic["driver"] == "train":
            readings = train_readings(run, args, tmp, sides)
        else:
            n = args.subjects or int(traffic["check"]["subjects"])
            readings = serve_readings(run, args, tmp, sides, traffic, n)
        for row in readings:
            # each row judged as a run is: the cell's limits, no
            # request failed
            verdict = harness.compare({**row["numbers"], "failed": 0.0},
                                      run.limits)
            print(json.dumps({"workload": args.workload,
                              "fault": args.fault, **row,
                              "correct": verdict["correct"]}), flush=True)
            if args.device.startswith("cuda"):
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
