"""Command-line training and inference (port of ``train_main`` and
``inference_main`` in flowtron_tpu/cli.py): ``-c config.json`` plus
``-p a.b=c`` overrides, the same flags as the JAX CLI. Runs on the first
CUDA device when there is one, else on the CPU.

    flowtron-torch-train -c config.json -p train_config.epochs=1 ...
    flowtron-torch-infer -c config.json -f model.pt -w waveglow.pt -t "text"
"""

import argparse

from flowtron_tpu.config import load_config


def train_main(argv=None):
    parser = argparse.ArgumentParser(
        description="Flowtron training (PyTorch/CUDA port)")
    parser.add_argument("-c", "--config", type=str, required=True,
                        help="JSON file for configuration")
    parser.add_argument("-p", "--params", nargs="+", default=[],
                        help="dotted-path overrides: a.b.c=value")
    args = parser.parse_args(argv)
    config = load_config(args.config, args.params)
    from flowtron_tpu_torch.train.loop import train
    train(config)


def inference_main(argv=None):
    parser = argparse.ArgumentParser(
        description="Flowtron inference (PyTorch/CUDA port)")
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("-p", "--params", nargs="+", default=[])
    parser.add_argument("-f", "--flowtron_path", type=str, required=True,
                        help="reference-format .pt state_dict")
    parser.add_argument("-w", "--waveglow_path", type=str, default="",
                        help="WaveGlow .pt state_dict (required: Griffin-Lim "
                             "is not ported yet)")
    parser.add_argument("-t", "--text", type=str, required=True)
    parser.add_argument("-i", "--id", type=int, default=0,
                        help="speaker id")
    parser.add_argument("-n", "--n_frames", type=int, default=400)
    parser.add_argument("-s", "--sigma", type=float, default=0.5)
    parser.add_argument("-g", "--gate", type=float, default=0.5)
    parser.add_argument("-o", "--output_dir", type=str, default="results")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("-d", "--denoise", type=float, default=0.0,
                        help="denoiser strength (not yet ported; must be 0)")
    parser.add_argument("--int8", action="store_true",
                        help="not yet ported")
    parser.add_argument("--quantize", choices=("w8", "w8a8", "w4"),
                        default="", help="not yet ported")
    parser.add_argument("--fused", action="store_true",
                        help="stop computing once every stream's gate has "
                             "fired (the decoder kernel's early exit); on "
                             "CUDA the flows always run the kernel")
    parser.add_argument("--stream", action="store_true",
                        help="not yet ported")
    args = parser.parse_args(argv)
    for flag, on in (("--quantize", args.quantize), ("--int8", args.int8),
                     ("--stream", args.stream)):
        if on:
            parser.error(f"{flag} is not yet ported to the PyTorch package "
                         "(see ROADMAP.md)")

    config = load_config(args.config, args.params)
    from flowtron_tpu_torch.infer.sampling import run_inference
    run_inference(config, args)


if __name__ == "__main__":
    inference_main()
