"""Style transfer from the command line (port of scripts/style_transfer.py;
the reference notebook inference_style_transfer.ipynb):

    python -m flowtron_tpu_torch.scripts.style_transfer -c config.json \\
        -f model.pt -r reference_filelist.txt -t "target text" -i 0 \\
        [-n 400 -s 0.5 -g 0.5 -o results --seed 1234 --lambd 1e-4]

Collects z over the reference utterances of the filelist, forms the ridge
posterior mean, samples around it and synthesizes the target text in the
transferred style (``infer/style_transfer.py``). Writes
``{output_dir}/style_sid{id}_seed{seed}_mel.npy`` and the Griffin-Lim
``.wav`` beside it. Runs on ``cuda:0`` (kernel K3's forward for the
references, K1 for the inversion), or the CPU with
``FLOWTRON_PLATFORM=cpu`` (``utils/device.py``).
"""

import argparse
import os

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Flowtron style transfer (PyTorch/CUDA port)")
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("-p", "--params", nargs="+", default=[])
    parser.add_argument("-f", "--flowtron_path", required=True)
    parser.add_argument("-r", "--reference_filelist", required=True,
                        help="filelist of style-reference utterances")
    parser.add_argument("-t", "--text", required=True)
    parser.add_argument("-i", "--id", type=int, default=0)
    parser.add_argument("-n", "--n_frames", type=int, default=400)
    parser.add_argument("-s", "--sigma", type=float, default=0.5)
    parser.add_argument("-g", "--gate", type=float, default=0.5)
    parser.add_argument("-o", "--output_dir", default="results")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--lambd", type=float, default=1e-4)
    args = parser.parse_args(argv)

    from flowtron_tpu_torch.config import load_config
    from flowtron_tpu_torch.data.collate import DataCollate
    from flowtron_tpu_torch.data.dataset import Data, data_kwargs
    from flowtron_tpu_torch.infer.sampling import (
        load_model_for_inference, mel_to_audio_griffinlim, write_wav)
    from flowtron_tpu_torch.infer.style_transfer import style_transfer
    from flowtron_tpu_torch.utils.device import resolve_device

    config = load_config(args.config, args.params)
    data_config = dict(config["data_config"])
    device = resolve_device()
    model, static_cfg = load_model_for_inference(config, args.flowtron_path,
                                                 device)
    dataset = Data(args.reference_filelist, **data_kwargs(data_config))
    batch = DataCollate(use_attn_prior=False)(
        [dataset[i] for i in range(len(dataset))])
    mel, n = style_transfer(model, static_cfg, batch,
                            dataset.get_text(args.text), args.id,
                            n_frames=args.n_frames, sigma=args.sigma,
                            gate_threshold=args.gate, seed=args.seed,
                            lam=args.lambd, device=device)
    print(f"synthesized {n} frames")

    os.makedirs(args.output_dir, exist_ok=True)
    base = os.path.join(args.output_dir, f"style_sid{args.id}_seed{args.seed}")
    np.save(base + "_mel.npy", mel)
    write_wav(base + ".wav", mel_to_audio_griffinlim(mel, data_config),
              data_config["sampling_rate"])
    print("wrote", base + ".wav")


if __name__ == "__main__":
    main()
