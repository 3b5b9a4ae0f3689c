"""The readings that set a cell's limits: its controls and its planted
fault, each judged by the cell's own limits, each of which has to come
out as not correct.

    python3 benchmark/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...]

Each seed runs the cell as the benchmark does, with the program's own
lower-precision path switched on where the cell's ``check.control`` names
its server flags (``--quantize w8a8`` for a bf16 cell: int8 flows): that
run's readings (every number ``check.compare`` gives, compared or not)
and ``correct`` are the program path's. Then, on the same
sample, against the same fp32 reference, it judges:

- the reference in the nearest lower precision in the program's place:
  TF32 for an fp32 configuration, fp8 (e4m3: both operands of every
  product and convolution rounded, one scale a tensor) for a bf16 one,
  which also covers the vocoder, where the program has no lower path;
- the fault ``one_peak``: the reference with its blocks of rows
  normalised by one peak in place of each row's own.

Seeds run one after another in one process; one JSON line a seed. The
benchmark's own runs never run this.
"""

import argparse
import copy
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(name, seed, seconds, device="cuda", config=None, cell=None):
    from benchmark import check
    from benchmark.run import execute, load_cell

    cell = copy.deepcopy(cell or load_cell(name)[2])
    flags = cell["check"].get("control", [])
    cell["server_flags"] = cell["server_flags"] + flags
    result, _lines, run = execute(name, seed, seconds, 0, device, config,
                                  cell)
    limits = cell["check"]["limits"]
    out = {"seed": seed, "attempted": result["attempted"],
           "failed": result["failed"], "sample": len(run.sample)}
    out["program_path" if flags else "program"] = {
        "flags": flags, "correct": result["correct"],
        "readings": run.readings}
    bf16 = run.dtype == "bfloat16"
    planted = {"fp8" if bf16 else "tf32": {"tf32": not bf16, "fp8": bf16},
               "one_peak": {"one_peak": True}}
    for label, kw in planted.items():
        low = check.reference_answers(run.config, run.checked, seed,
                                      run.n_frames, device, **kw)
        got, _record = check.compare([pcm for _m, pcm in low], run.reference,
                                     [m for m, _p in low])
        out[label] = {"correct": check.judge(got, limits)[1],
                      "readings": got}
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds)),
              flush=True)


if __name__ == "__main__":
    main()
