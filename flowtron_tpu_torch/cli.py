"""Command-line training and inference (port of ``train_main`` and
``inference_main`` in flowtron_tpu/cli.py): ``-c config.json`` plus
``-p a.b=c`` overrides, the same flags as the JAX CLI. Runs on ``cuda:0``;
``FLOWTRON_PLATFORM=cpu`` runs on the CPU instead, and without CUDA and
without that variable the commands raise (``utils/device.py``).

    flowtron-torch-train -c config.json -p train_config.epochs=1 ...
    flowtron-torch-infer -c config.json -f model.pt [-w waveglow.pt] -t "text"
        [-d 0.1] [--stream]
    flowtron-torch-evaluate -c config.json -f model.pt [--plots DIR]
        [--tone-cer N] [--invertibility-frames 100] [--seed 1234]
"""

import argparse

from flowtron_tpu_torch.config import load_config


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
                        help="reference-format .pt state_dict or a JAX "
                             "package pickle checkpoint")
    parser.add_argument("-w", "--waveglow_path", type=str, default="",
                        help="WaveGlow .pt or JAX package pickle; without "
                             "it the mel is vocoded by Griffin-Lim on the "
                             "host")
    parser.add_argument("-t", "--text", type=str, required=True)
    parser.add_argument("-i", "--id", type=int, default=0,
                        help="speaker id")
    parser.add_argument("-n", "--n_frames", type=int, default=400)
    parser.add_argument("-s", "--sigma", type=float, default=0.5)
    parser.add_argument("-g", "--gate", type=float, default=0.5)
    parser.add_argument("-o", "--output_dir", type=str, default="results")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("-d", "--denoise", type=float, default=0.0,
                        help="WaveGlow bias-denoiser strength (0 = off)")
    parser.add_argument("--int8", action="store_true",
                        help="int8 weight-only flows (alias for --quantize "
                             "w8)")
    parser.add_argument("--quantize", choices=("w8", "w8a8", "w4"),
                        default="",
                        help="flow-weight quantization: w8 = int8 weights, "
                             "w8a8 = int8 weights and activations (kernel "
                             "K4), w4 = packed int4 weights")
    parser.add_argument("--fused", action="store_true",
                        help="stop computing once every stream's gate has "
                             "fired (the decoder kernel's early exit); on "
                             "CUDA the flows always run the kernel")
    parser.add_argument("--stream", action="store_true",
                        help="write the wav chunk by chunk as synthesis "
                             "runs (needs -w)")
    args = parser.parse_args(argv)

    config = load_config(args.config, args.params)
    from flowtron_tpu_torch.infer.sampling import run_inference
    run_inference(config, args)


def evaluate_main(argv=None):
    """Checkpoint health check without training: the validation nll /
    gate / ctc over the config's validation filelist, the health means,
    optional plots and tone-CER, and the invertibility oracle. Prints one
    JSON line (unrounded floats)."""
    import json

    parser = argparse.ArgumentParser(
        description="Evaluate a Flowtron checkpoint (PyTorch/CUDA port)")
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("-p", "--params", nargs="+", default=[])
    parser.add_argument("-f", "--flowtron_path", type=str, required=True,
                        help=".pt checkpoint (a training checkpoint or a "
                             "reference-format state_dict) or a JAX "
                             "package pickle checkpoint")
    parser.add_argument("--invertibility-frames", type=int, default=100,
                        help="latent frames for the round-trip oracle "
                             "(0 disables it)")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--plots", type=str, default="",
                        help="directory for attention.png and gate.png of "
                             "a validation batch")
    parser.add_argument("--tone-cer", type=int, default=0,
                        help="synthesize this many validation transcripts "
                             "and report the tone-CER (coded-tone corpora "
                             "only; 0 disables)")
    args = parser.parse_args(argv)

    config = load_config(args.config, args.params)
    from flowtron_tpu_torch.train.evaluate import evaluate
    result = evaluate(config, args.flowtron_path,
                      invertibility_frames=args.invertibility_frames,
                      seed=args.seed, plots_dir=args.plots or None,
                      tone_cer_texts=args.tone_cer)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    inference_main()
