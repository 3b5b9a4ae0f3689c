"""Where K2's bf16 body spends its time on the card: the kernel of
csrc/wavenet_bf16.cuh built as it is and with one part taken out at a
time, timed in turns on one layer in CUDA graphs.

    python -m flowtron_tpu_torch.scripts.k2_bf16_study [B] [--rounds R]

Each variant is a copy of the header with one piece of its source
replaced, built by nvcc (with the port's flags) beside a small C entry
into ``build/torch_kernels/k2_study/``:

- ``kernel``: the header as it is;
- ``no_loads``: no x or weight box loaded (each product's slot handed
  over empty: the products run on whatever the ring holds);
- ``no_gate``: the gate's arithmetic skipped (z left as it was);
- ``no_epilogue``: the res/skip epilogue's arithmetic and its TMA stores
  skipped;
- ``no_gate_no_epilogue``: both;
- ``gate_ex2_rcp``: the gate as tanh(a) = (1 - e) / (1 + e), e =
  exp(-2 |a|), and sigmoid(b) = 1 / (1 + exp(-b)), with ex2.approx and
  rcp.approx (four special-function ops a z, not two tanh.approx);
- ``gate_tanh_sigmoid_ex2``: tanh.approx, and the sigmoid as above.

``kernel`` and the two gate forms compute the layer (the kernel's error
against the plain version is printed); the others time what is left. One layer at the flagship
vocoder's width (C = 256, layer 3, d = 8) at T = 12800 (400 mel frames),
B=1 by default, on init-scaled random bf16 weights, tiled as
``wn_bf16_plan`` says. Prints the card's name and power limit, then one
JSON line: each variant's median and runs of the device ms per call (10
calls a graph, the graphs replayed in turns, ``--rounds`` times). Needs
CUDA and nvcc.
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from flowtron_tpu_torch.ops import _build
from flowtron_tpu_torch.ops import wavenet as W

# variant -> [(source text, its replacement)], each text found once
_PRODUCER_K1 = "            next(K::XB + K::WB, dst, bar);\n" \
    "            tma3(dst, &m.x, k - tap * C, t0 + (tap - 1) * d, bi, bar);\n" \
    "            tma2(dst + K::XB, &m.w1, k, h * N1, bar);\n"
_PRODUCER_K2 = "            next(K::WB, dst, bar);\n" \
    "            tma2(dst, &m.w2, kc * kBK, p * N1, bar);\n"
_GATE = "#pragma unroll\n        for (int q = 0; q < N1 / 16; ++q) {"
_EPI = "#pragma unroll\n          for (int j = 0; j < HALF / 8; ++j) {"
_STORE = "          if ((threadIdx.x & 127) == 0) {"
_NO_GATE = [(_GATE, "        if (false)\n" + _GATE)]
_NO_EPI = [(_EPI, "          if (false)\n" + _EPI),
           (_STORE, "          if (false) {")]
_GATE_FN = """__device__ __forceinline__ float gate(float at, float as) {
  return tanh_approx(at) * fmaf(0.5f, tanh_approx(0.5f * as), 0.5f);
}"""
_SIGMOID_EX2 = "__fdividef(1.f, 1.f + __expf(-as))"
_TANH_EX2 = """const float e = __expf(-2.f * fabsf(at));
  return copysignf(__fdividef(1.f - e, 1.f + e), at) * """
VARIANTS = {
    "kernel": [],
    "no_loads": [(_PRODUCER_K1, "            next(0, dst, bar);\n"),
                 (_PRODUCER_K2, "            next(0, dst, bar);\n")],
    "no_gate": _NO_GATE,
    "no_epilogue": _NO_EPI,
    "no_gate_no_epilogue": _NO_GATE + _NO_EPI,
    "gate_ex2_rcp": [(_GATE_FN, _GATE_FN.replace(
        "return tanh_approx(at) * fmaf(0.5f, tanh_approx(0.5f * as), 0.5f);",
        _TANH_EX2 + _SIGMOID_EX2 + ";"))],
    "gate_tanh_sigmoid_ex2": [(_GATE_FN, _GATE_FN.replace(
        "fmaf(0.5f, tanh_approx(0.5f * as), 0.5f)", _SIGMOID_EX2))],
}

_ENTRY = """#include "{header}"
extern "C" int study_launch(const void* x, int d, const void* cond, int ldc,
                            const void* w1, const void* b, const void* w2,
                            const void* b_rs, void* x_out, void* skip,
                            int B, int Tp, int T, int C, int bm, int grid,
                            void* stream) {{
  int cfg[3];
  const wn16::Args a{{x, cond, b, b_rs, w1, w2, x_out, skip,
                      d, ldc, B, T, Tp, grid}};
  return wn16::dispatch(C, bm, false, cfg, &a,
                        static_cast<cudaStream_t>(stream));
}}
"""


def build(name, source, out_dir):
    """The variant's header and C entry, compiled; returns the CDLL."""
    text = source
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: the source text to replace "
                               f"is not in csrc/wavenet_bf16.cuh once:\n{old}")
        text = text.replace(old, new)
    header = out_dir / f"k2_study_{name}.cuh"
    header.write_text(text)
    entry = out_dir / f"k2_study_{name}.cu"
    entry.write_text(_ENTRY.format(header=header.name))
    lib = out_dir / f"k2_study_{name}.so"
    cmd = [_build._nvcc()] + _build.NVCC_FLAGS + ["-I", str(_build.CSRC),
                                                  "-o", str(lib), str(entry)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"building {name} failed:\n{proc.stderr[-4000:]}")
    dll = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.study_launch.argtypes = [p, i, p, i, p, p, p, p, p, p, i, i, i, i, i,
                                 i, p]
    dll.study_launch.restype = i
    return dll


def graph_of(fn, reps):
    """fn() called ``reps`` times in one CUDA graph, after a warm-up."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    return g


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("B", nargs="?", type=int, default=1)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_bf16_study: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out_dir = _build.BUILD_DIR / "k2_study"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "wavenet_bf16.cuh").read_text()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(
            lambda n: build(n, source, out_dir), VARIANTS)))

    dev = torch.device("cuda", 0)
    B, C, L, layer, T = args.B, 256, 8, 3, 12800
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device=dev)) \
            .bfloat16()

    x = rand(B, T, C)
    cond = rand(B, T, 2 * C * L)[..., 2 * C * layer:2 * C * (layer + 1)]
    w_cat, b = rand(3 * C, 2 * C, scale=(3 * C) ** -0.5), rand(2 * C, scale=.1)
    w_rs, b_rs = rand(C, 2 * C, scale=C ** -0.5), rand(2 * C, scale=0.1)
    w1, w2 = W.wn_pack_weights(w_cat, w_rs)
    plan = W.wn_bf16_plan(B, T, C, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    x_out, skip = torch.empty_like(x), torch.empty_like(x)

    def launch(dll):
        err = dll.study_launch(
            x.data_ptr(), 2 ** layer, cond.data_ptr(), cond.stride(1),
            w1.data_ptr(), b.data_ptr(), w2.data_ptr(), b_rs.data_ptr(),
            x_out.data_ptr(), skip.data_ptr(), B, T, T, C, plan.bm,
            plan.grid, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")

    launch(libs["kernel"])
    ref = W.wn_layer_reference(x, 2 ** layer, cond, w_cat, b, w_rs, b_rs, T)
    err = max(float((o.float() - r.float()).abs().max())
              for o, r in zip((x_out, skip), ref))
    graphs = {n: graph_of(lambda d=d: launch(d), 10)
              for n, d in libs.items()}
    runs = {n: [] for n in graphs}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(args.rounds):
        for n in list(graphs) + list(graphs)[::-1]:
            start.record()
            graphs[n].replay()
            end.record()
            torch.cuda.synchronize()
            runs[n].append(start.elapsed_time(end) / 10)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "B": B, "C": C, "T": T,
        "layer": layer, "plan": plan._asdict(), "kernel_max_abs_err": err,
        "ms": {n: statistics.median(r) for n, r in runs.items()},
        "runs_ms": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
