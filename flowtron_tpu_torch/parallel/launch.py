"""Start the ranks of one function on this host, each a fresh Python
process with the environment ``torchrun`` sets, and collect what each
returns.

    results = launch("pkg.module:function", world=2, kwargs={...})

Each rank joins the process group through ``maybe_initialize_distributed(
{"multiprocess": True})`` (gloo on the CPU or on a shared card, NCCL when
every rank has a card), calls ``function(**kwargs)``, leaves the group
and hands its return value back (``torch.save``; only files these ranks
wrote are read back). A rank that fails or outlives ``timeout_s`` fails
the launch: every other rank is stopped and the error names the rank and
ends with its stderr. Rank 0's stdout is echoed to the caller's.

The tests and ``chip_smoke.py`` use it, and so does
``entry.py:dryrun_multichip``; a user starts a training run with
``torchrun`` or ``dist_config`` instead (README.md).
"""

import importlib
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch


def free_port():
    """A TCP port of localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path, n=4000):
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def launch(target, world, kwargs=None, timeout_s=600, env=None):
    """Run ``target`` ("module:function") on ranks 0..world-1; returns
    their return values in rank order."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    base = dict(os.environ, **(env or {}))
    base["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.getcwd(), root, base.get("PYTHONPATH")) if p)
    base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    with tempfile.TemporaryDirectory(prefix="flowtron_ranks_") as tmp:
        job = os.path.join(tmp, "job.pt")
        torch.save({"target": target, "kwargs": kwargs or {}}, job)
        procs, logs = [], []
        try:
            for r in range(world):
                out = open(os.path.join(tmp, f"out_{r}.txt"), "w")
                err = open(os.path.join(tmp, f"err_{r}.txt"), "w")
                logs.append((out, err))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "flowtron_tpu_torch.parallel.launch",
                     job, str(r)],
                    env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                    stdout=out, stderr=err, stdin=subprocess.DEVNULL))
            deadline = time.monotonic() + timeout_s
            failed = None
            while failed is None and any(p.poll() is None for p in procs):
                failed = next((r for r, p in enumerate(procs)
                               if p.poll() not in (None, 0)), None)
                if time.monotonic() > deadline:
                    failed = next(r for r, p in enumerate(procs)
                                  if p.poll() is None)
                time.sleep(0.05)
            if failed is None:
                failed = next((r for r, p in enumerate(procs)
                               if p.returncode != 0), None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for out, err in logs:
                out.close()
                err.close()
        sys.stdout.write(_tail(os.path.join(tmp, "out_0.txt"), 1 << 20))
        sys.stdout.flush()
        if failed is not None:
            raise RuntimeError(
                f"rank {failed} of {world} ({target}) failed with exit "
                f"code {procs[failed].returncode}:\n"
                + _tail(os.path.join(tmp, f"err_{failed}.txt")))
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"),
                           weights_only=False) for r in range(world)]


def _rank_main(job_path, rank):
    from flowtron_tpu_torch.parallel.mesh import (
        destroy, maybe_initialize_distributed)

    job = torch.load(job_path, weights_only=False)
    module, _, name = job["target"].partition(":")
    fn = getattr(importlib.import_module(module), name)
    maybe_initialize_distributed({"multiprocess": True})
    try:
        result = fn(**job["kwargs"])
    finally:
        destroy()
    torch.save(result, os.path.join(os.path.dirname(job_path),
                                    f"result_{rank}.pt"))


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
