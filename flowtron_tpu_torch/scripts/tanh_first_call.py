"""How often the first CPU ``torch.tanh`` call of a fresh process is less
accurate than rounding, with and without the port's import (whose
``flowtron_tpu_torch._warm_vector_math`` warms tanh up on one thread).

    python -m flowtron_tpu_torch.scripts.tanh_first_call [N] [--jobs J]

Starts N fresh processes each way (default 600, J at a time, default 6,
as the tier-1 command's xdist workers), each calling ``torch.tanh`` once
on 2^18 normal float32 values, and prints one JSON line: for "torch
alone" and "after the port's import", the processes whose largest error
against float64 passed 1e-6, and the largest error seen. Runs on the CPU.
"""

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

CHILD = """
import sys
import numpy as np
if sys.argv[1] == "port":
    import flowtron_tpu_torch  # noqa: F401
import torch
x = np.random.default_rng(int(sys.argv[2])).standard_normal(1 << 18)
x = x.astype(np.float32)
y = torch.tanh(torch.from_numpy(x)).numpy()
print(float(np.abs(y - np.tanh(x.astype(np.float64))).max()))
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("n", nargs="?", type=int, default=600)
    ap.add_argument("--jobs", type=int, default=6)
    a = ap.parse_args()

    def one(arm, seed):
        return float(subprocess.run(
            [sys.executable, "-c", CHILD, arm, str(seed)], check=True,
            capture_output=True, text=True).stdout)

    out = {}
    for arm, name in (("torch", "torch alone"),
                      ("port", "after the port's import")):
        with ThreadPoolExecutor(a.jobs) as ex:
            errs = list(ex.map(lambda s: one(arm, s), range(1, a.n + 1)))
        out[name] = dict(processes=a.n, above_1e6=sum(e > 1e-6 for e in errs),
                         max_err=max(errs))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
