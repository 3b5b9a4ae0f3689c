"""Run one cell of the benchmark of ``flowtron_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs/<config>.json``: the model, the vocoder and how they
are served) and its own file (``benchmark/workloads/<cell>.json``: server
flags, text corpus, traffic kind and parameters, the traced slice, the
sample checked and its limits). The run:

1. makes the weights from ``--seed`` on the card and hands them to the
   port's HTTP server, built in-process by ``serve/cli.py:build_server``
   on port 0 with ``--warmup`` (the kernels build into
   ``benchmark/.cache``, so only a checkout's first run compiles);
2. sends one request outside the window, then starts the callers in a
   child process (``benchmark/client.py``) on the traffic of the cell,
   drawn from the seed; ``setup_s`` ends at the window's first request;
3. with ``--trace 1``, profiles a fixed slice of the window, with spans
   around the calls into the program's layers (``benchmark/trace.py``);
   every run reports the answers a second within that slice beside the
   window's, so a traced run's cost to the server shows;
4. after the window, reads the peak device memory, shuts the server
   down, and holds a sample of the answers against the plain reference
   (``benchmark/check.py``);
5. prints the numbers compared, each beside its limit, as the last lines
   of standard error, and one JSON line on standard output: ``correct``,
   ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
   or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
   1`` a ``breakdown``, and ``checks`` last.

It exits 2 without a result where no card (or too few) is visible, and
3 where ``jax``, ``jaxlib``, ``flax`` or ``flowtron_tpu`` was loaded.
"""

import time

T_START = time.monotonic()

import argparse       # noqa: E402 - the clock starts before any import
import base64         # noqa: E402
import gc             # noqa: E402
import importlib.util  # noqa: E402
import json           # noqa: E402
import os             # noqa: E402
import random         # noqa: E402
import subprocess     # noqa: E402
import sys            # noqa: E402
import threading      # noqa: E402
import urllib.request  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "flowtron_tpu")
CLIENT_LEAD_S = 1.0          # the callers' process starts within this
HOP = 256


def load_json(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_cell(name):
    """(BENCHMARK.json, the cell's entry, its workload file, its
    configuration file)."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return (bench, entry, load_json(os.path.join(HERE, "workloads",
                                                 f"{name}.json")),
            load_json(os.path.join(ROOT, cfg["file"])))


def cell_metrics(bench, name, section):
    return [m for m in bench[section]
            if "workloads" not in m or name in m["workloads"]]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def request_bodies(cell, name, seed, n):
    """The cell's requests: texts (with their speakers) from its corpus
    and per-request latent seeds, all drawn from the run's seed."""
    path = os.path.join(HERE, "texts", f"{cell['corpus']}.txt")
    with open(path, encoding="utf-8") as f:
        lines = [line.rstrip("\n").split("|", 1) for line in f if line.strip()]
    rng = random.Random(f"{name}-{seed}")
    bodies = []
    for _ in range(n):
        sid, text = lines[rng.randrange(len(lines))]
        bodies.append({"text": text, "speaker_id": int(sid),
                       "seed": rng.randrange(2 ** 31),
                       "sigma": cell["traffic"].get("sigma", 0.5)})
    return bodies


def http_json(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def warm_request(url, endpoint, body):
    """One answered request outside the window: the HTTP path's first-use
    costs are set-up."""
    req = urllib.request.Request(url + endpoint, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        r.read()


def sleep_until(t):
    dt = t - time.monotonic()
    if dt > 0:
        time.sleep(dt)


def server_argv(config_path, ft_path, wg_path, config, cell):
    return (["-c", config_path, "-f", ft_path, "-w", wg_path, "--port", "0",
             "--warmup", "--compile-cache", os.path.join(CACHE, "kernels")]
            + config["serve"]["flags"] + cell["server_flags"])


class Run:
    """One run of a cell; what the metric readers see (``run.trace``,
    ``run.records``, ``run.window``, ...)."""

    def __init__(self, name, seed, seconds, trace, device="cuda",
                 config=None, cell=None):
        self.bench, self.entry, self.cell, self.config = load_cell(name)
        self.config = config or self.config
        self.cell = cell or self.cell
        self.name, self.seed, self.seconds = name, int(seed), float(seconds)
        self.traced = bool(trace)
        self.device = device
        self.t_start = T_START
        self.dtype = self.config["serve"]["dtype"]
        flags = self.cell["server_flags"]
        self.n_frames = int(flags[flags.index("--n-frames") + 1])
        self.max_batch = int(flags[flags.index("--max-batch") + 1])
        self.samples = self.n_frames * HOP
        self.trace = None
        self.slice = None           # the traced slice, its processing in
        self.traced_span = None     # the profiler's own window

    # -- the system under test --------------------------------------------
    def start_server(self):
        import torch
        from benchmark import weights
        from flowtron_tpu_torch.serve.cli import build_server

        dev = torch.device(self.device)
        if self.traced and dev.type == "cuda":
            from benchmark.trace import prime
            prime(dev)
        # TF32 off, as in the reference: the server sets neither flag, and
        # PyTorch leaves cuDNN's on
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        files = weights.MemoryFiles()
        try:
            dt = getattr(torch, self.dtype)
            ft, wg = weights.model_weights(self.config, self.seed, dev)
            ft_path = files.save("flowtron", {k: v.to(dt)
                                              for k, v in ft.items()})
            wg_path = files.save("waveglow", {k: v.to(dt)
                                              for k, v in wg.items()},
                                 self.config["waveglow_config"])
            del ft, wg
            config_path = os.path.join(files.dir, "config.json")
            with open(config_path, "w") as f:
                json.dump({k: self.config[k] for k in (
                    "train_config", "data_config", "dist_config",
                    "model_config")}, f)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            self.server, self.engines = build_server(
                server_argv(config_path, ft_path, wg_path, self.config,
                            self.cell), host="127.0.0.1")
        finally:
            files.close()
        self.engine = self.engines["default"]
        if self.traced:
            from benchmark.trace import Spans
            self.spans = Spans()
            self.spans.install(self.engine)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def stop_server(self):
        import torch

        self.server.shutdown()
        self.server.server_close()
        for eng in list(self.engines.values()):
            eng.shutdown()
        self.server = self.engines = self.engine = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # -- the window ---------------------------------------------------------
    def drive(self):
        from benchmark.traffic import kind

        traffic = self.cell["traffic"]
        schedule = kind(traffic["kind"]).schedule(traffic, self.seed,
                                                  self.seconds)
        self.bodies = request_bodies(self.cell, self.name, self.seed,
                                     schedule["n_requests"])
        self.candidates = self.sample_candidates()
        from benchmark.check import MelTap
        self.tap = MelTap(self.engine, [self.bodies[i]["seed"]
                                        for i in self.candidates])
        warm = dict(self.bodies[0], seed=self.bodies[0]["seed"] ^ 1)
        warm_request(self.url, traffic["endpoint"], warm)
        client = subprocess.Popen(
            [sys.executable, "-m", "benchmark.client"], cwd=ROOT,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        try:
            t0 = time.monotonic() + CLIENT_LEAD_S
            self.window = (t0, t0 + self.seconds)
            client.stdin.write(json.dumps({
                "url": self.url, "endpoint": traffic["endpoint"],
                "kind": traffic["kind"], "schedule": schedule,
                "bodies": self.bodies, "t0": t0,
                "seconds": self.seconds}) + "\n")
            client.stdin.flush()
            sleep_until(t0)
            before = http_json(self.url + "/metrics")
            if self.traced:
                self.capture(t0)
            sleep_until(t0 + self.seconds)
            self.server_metrics = (before, http_json(self.url + "/metrics"))
            out = json.loads(client.stdout.readline())
            self.records = sorted(out["records"], key=lambda r: r["i"])
            self.client_start = out["started"]
            self.sample = self.choose_sample()
            client.stdin.write(json.dumps(self.sample) + "\n")
            client.stdin.flush()
            kept = json.loads(client.stdout.readline())
            client.wait(timeout=60)
        finally:
            if client.poll() is None:
                client.kill()
                client.wait()
        import numpy as np
        self.answers = {int(i): np.frombuffer(base64.b64decode(b), "<i2")
                        for i, b in kept.items()}

    def capture(self, t0):
        from benchmark.trace import capture

        tr = self.cell["trace"]
        sleep_until(t0 + tr["start_s"])
        a = time.monotonic()
        self.trace, self.traced_span = capture(tr["seconds"], self.spans,
                                               self.device)
        self.slice = (a, time.monotonic())

    def slice_rate(self):
        """(start, end) of the traced slice on the window's clock (where a
        run traces none, the slice it would trace) and the answers a
        second within it."""
        from benchmark.endtoend import answered_in

        t0 = self.window[0]
        a, b = self.traced_span or (t0 + self.cell["trace"]["start_s"],
                                    t0 + self.cell["trace"]["start_s"]
                                    + self.cell["trace"]["seconds"])
        return a - t0, b - t0, len(answered_in(self, a, b)) / (b - a)

    def sample_candidates(self):
        """The requests the check may draw from, drawn from the seed before
        the window: one in four of the requests (a closed loop sends an
        unknown number)."""
        rng = random.Random(f"sample-{self.name}-{self.seed}")
        return {i for i in range(len(self.bodies)) if rng.random() < 0.25}

    def choose_sample(self):
        """Candidates answered in the window, drawn from the seed, with the
        one of the longest text among them."""
        t0, t1 = self.window
        done = [r["i"] for r in self.records
                if r["status"] == 200 and t0 <= r["due"] <= t1
                and r["i"] in self.candidates]
        if not done:
            return []
        longest = max(done, key=lambda i: len(self.bodies[i]["text"]))
        rest = [i for i in done if i != longest]
        random.Random(f"draw-{self.name}-{self.seed}").shuffle(rest)
        return sorted([longest] + rest[:self.cell["check"]["requests"] - 1])

    # -- after the window -----------------------------------------------------
    def verify(self):
        from benchmark import check

        self.checked = [self.bodies[i] for i in self.sample]
        self.reference = check.reference_answers(
            self.config, self.checked, self.seed, self.n_frames, self.device)
        mels = [self.tap.host(self.bodies[i]["seed"]) for i in self.sample]
        self.readings, self.record = check.compare(
            [self.answers.get(i) for i in self.sample], self.reference, mels)
        if len(self.sample) < self.cell["check"]["requests"]:
            # too few answers to judge is not correct
            self.readings["length_mismatch"] += \
                self.cell["check"]["requests"] - len(self.sample)
        self.checks, self.correct = check.judge(self.readings,
                                                self.cell["check"]["limits"])

    def metrics(self):
        from benchmark import endtoend

        out = {}
        if not self.traced:
            for m in cell_metrics(self.bench, self.name, "end_to_end"):
                out[m["name"]] = {"value": endtoend.METRICS[m["name"]](self),
                                  "unit": m["unit"]}
            return out
        from benchmark.reference.frontend import TextIds
        ids = TextIds(self.config["data_config"])
        self.n_keys = {r["i"]: len(ids.ids(self.bodies[r["i"]]["text"]))
                       for r in self.records}
        for m in cell_metrics(self.bench, self.name, "per_layer"):
            path = os.path.join(HERE, "metrics", f"{m['name']}.py")
            spec = importlib.util.spec_from_file_location(
                f"benchmark.metrics.{m['name'].replace('.', '_')}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            value = module.read(self)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out

    def result(self, memory_peak, device_info):
        ok = [r for r in self.records if r["status"] == 200
              and r["samples"] == self.samples]
        res = {"correct": self.correct, "attempted": len(self.records),
               "failed": len(self.records) - len(ok),
               "metrics": self.metrics(),
               "device": dict(device_info, memory_peak_bytes=memory_peak)}
        if self.traced:
            res["device"]["busy_s"] = self.trace.busy_s()
            res["device"]["window_s"] = self.trace.window_s()
            res["breakdown"] = {"device_ops": self.trace.top_ops(),
                                "idle_gaps": self.trace.idle_gaps()}
        a, b, rate = self.slice_rate()
        res["slice"] = {"start_s": a, "end_s": b, "traced": self.traced,
                        "requests_per_s": rate}
        res["checks"] = self.checks
        return res


def execute(name, seed, seconds, trace, device="cuda", config=None,
            cell=None):
    """Run a cell; returns (result dict, stderr lines, the ``Run``).
    ``config`` and ``cell`` stand in for the cell's files (the tests' tiny
    sizes, the control's flags)."""
    import torch

    run = Run(name, seed, seconds, trace, device, config, cell)
    run.start_server()
    run.drive()
    dev = torch.device(device)
    if dev.type == "cuda":
        memory_peak = int(torch.cuda.max_memory_allocated(dev))
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": run.entry["chips"]}
    else:
        memory_peak, info = 0, {"platform": "cpu", "kind": "cpu", "count": 1}
    run.tap.mels = {s: m.cpu() for s, m in run.tap.mels.items()}
    run.stop_server()
    run.verify()
    a, b, rate = run.slice_rate()
    lines = [f"callers: started {run.client_start - run.window[0]:+.4f} s "
             f"from the window",
             f"slice {a:.3f}-{b:.3f} s of the window "
             f"({'traced' if run.traced else 'not traced'}): {rate!r} "
             f"answers/s"]
    failed = [r for r in run.records if r["status"] != 200
              or r["samples"] != run.samples]
    if failed:
        lines.append(f"failed {len(failed)}: " + "; ".join(
            f"#{r['i']} status {r['status']} samples {r['samples']} "
            f"{r['error']}" for r in failed[:3]))
    for k, v in run.record.items():
        if v:
            lines.append(f"answers checked, {k}: "
                         + " ".join(f"{x:.4g}" for x in v))
    lines += [f"check {k} {v['value']!r} limit {v['limit']!r}"
              for k, v in run.checks.items()]
    return run.result(memory_peak, info), lines, run


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    # every build and kernel cache at a fixed path inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(CACHE, "nv"))
    import torch

    _bench, entry, _cell, _config = load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry["chips"]:
        print(f"needs {entry['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines, _run = execute(args.workload, args.seed, args.seconds,
                                  args.trace)
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
