"""Train the WaveGlow vocoder, data-parallel over the ranks (port of
scripts/train_waveglow.py):

    python -m flowtron_tpu_torch.scripts.train_waveglow \\
        -c configs/config_waveglow.json [-p a.b=c ...]

Random audio segments -> log-mel conditioning -> the flow NLL of
``vocoder/waveglow.py:waveglow_forward`` / ``waveglow_loss`` -> Adam
(``torch.optim.Adam``, betas (0.9, 0.999), eps 1e-8: optax.adam's math).
With ``train_config.fp16_run`` the step follows the JAX script's bf16
policy: every floating parameter is cast to bf16 for the pass (the fp32
masters take the gradients), mel and audio are cast to bf16, and z,
log_s and log_det are cast to fp32 before the loss.

Batches are drawn as the JAX script draws them: one
``np.random.default_rng(seed)`` picks each row's file, then its offset, a
segment of ``segment_length`` cut to a multiple of the hop; shorter files
are zero-padded; the mel is the port's ``MelSpectrogram.mel_numpy`` of
each segment. So a seed draws the same batches in both packages.

Every ``iters_per_checkpoint`` iterations, from iteration 0 on, it writes
``{output_directory}/waveglow_{iteration}.pt``: ``{"model": state_dict in
the published names, "config": the waveglow_config}``, which
``torch.load(..., weights_only=True)`` and ``load_waveglow`` read at its
width. Each step prints ``iteration:\\tloss\\t(seconds)`` as the JAX
script does.

Like the JAX script, it reads neither ``checkpoint_path`` nor
``with_tensorboard``. It runs on this rank's card (``cuda:0`` for one
process), or the CPU with ``FLOWTRON_PLATFORM=cpu`` (``utils/device.py``).
Under several processes (``dist_config`` or ``torchrun`` with
``dist_config.multiprocess=true``, parallel/mesh.py) the global batch is
``batch_size`` x world, as the JAX script trains ``batch_size`` x n_dev
over a mesh of every device whatever ``dist_config`` says: every rank
draws the same global batch from the one seeded generator and takes its
``batch_size`` rows; its loss is its rows' sums over the global batch's
element count, and the gradients are summed over the ranks before Adam,
so each step is the global batch's. A ``model`` axis in ``mesh_shape``
changes nothing here: every rank is on the batch, as in the JAX script.
Only rank 0 prints and writes the checkpoints.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from flowtron_tpu_torch.audio.stft import MelSpectrogram
from flowtron_tpu_torch.config import update_params
from flowtron_tpu_torch.data.dataset import load_wav
from flowtron_tpu_torch.parallel.mesh import (
    all_reduce_sum, broadcast_module, maybe_initialize_distributed,
    process_grid, rank, sync_gradients, world_size,
)
from flowtron_tpu_torch.utils.device import resolve_device
from flowtron_tpu_torch.vocoder.waveglow import (
    waveglow_forward, waveglow_init, waveglow_loss,
)


def training_files(path):
    """The filelist's first column, one entry a line, as the JAX script's
    ``load_filepaths_and_text`` reads it."""
    with open(path, encoding="utf-8") as f:
        return [line.strip().split("|")[0] for line in f]


def sample_batch(rng, files, batch_size, seg, data_config, mel_fn,
                 rows=None):
    """(mel (B, n_mel, seg // hop), audio (B, seg)) float32 numpy: for
    each row a file and then an offset from ``rng``, as the JAX script's
    ``sample_batch``. ``rows`` (a slice) keeps those rows of the batch
    (all are drawn, so ``rng`` advances as for the whole batch)."""
    audio = np.zeros((batch_size, seg), np.float32)
    for i in range(batch_size):
        wav, _ = load_wav(files[rng.integers(len(files))])
        wav = wav / data_config["max_wav_value"]
        if len(wav) >= seg:
            s = rng.integers(len(wav) - seg + 1)
            audio[i] = wav[s:s + seg]
        else:
            audio[i, :len(wav)] = wav
    if rows is not None:
        audio = audio[rows]
    mel = np.stack([mel_fn(a)[:, :seg // data_config["hop_length"]]
                    for a in audio])
    return mel, audio


def waveglow_train_loss(model, wg_cfg, mel, audio, sigma, compute_dtype):
    """The fp32 loss of one batch under the precision policy."""
    z, log_s, log_det = waveglow_forward(model, wg_cfg, mel, audio,
                                         compute_dtype=compute_dtype)
    f32 = torch.float32
    return waveglow_loss(z.to(f32), [ls.to(f32) for ls in log_s],
                         [ld.to(f32) for ld in log_det], sigma)


def make_step(model, wg_cfg, optimizer, sigma, compute_dtype=None):
    """``step(mel, audio)`` -> the loss (a 0-d tensor, the global batch's
    under several ranks): forward, backward, the gradients summed over
    the ranks, one Adam step. Every rank holds as many rows, so its rows'
    sums over the global element count are its loss over the world
    size."""
    world = world_size()

    def step(mel, audio):
        loss = waveglow_train_loss(model, wg_cfg, mel, audio, sigma,
                                   compute_dtype)
        if world > 1:
            loss = loss / world
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        sync_gradients(list(model.parameters()))
        optimizer.step()
        return all_reduce_sum(loss.detach())
    return step


def main(argv=None):
    """Train as the config says. Returns (model, waveglow_config, history:
    a dict a step with its iteration, loss and ``step_s``, the seconds of
    the step alone, the batch's drawing not counted)."""
    parser = argparse.ArgumentParser(
        description="WaveGlow training (PyTorch/CUDA port)")
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("-p", "--params", nargs="+", default=[])
    args = parser.parse_args(argv)
    with open(args.config) as f:
        config = json.load(f)
    if args.params:
        update_params(config, args.params)
    tc, dc, wc = (config["train_config"], config["data_config"],
                  config["waveglow_config"])
    dist_config = config.get("dist_config", {})
    maybe_initialize_distributed(dist_config)
    process_grid(dist_config)       # a grid that holds the world's ranks
    world, lead = world_size(), rank() == 0
    device = resolve_device()

    seed = int(tc.get("seed", 1234))
    model, wg_cfg = waveglow_init(seed, device=device, **wc)
    broadcast_module(model)
    local = int(tc["batch_size"])
    batch_size = local * world
    rows = slice(rank() * local, (rank() + 1) * local)
    hop = dc["hop_length"]
    seg = (int(dc["segment_length"]) // hop) * hop
    ms = MelSpectrogram(dc["filter_length"], hop, dc["win_length"],
                        wc["n_mel_channels"], dc["sampling_rate"],
                        dc["mel_fmin"], dc["mel_fmax"])
    files = training_files(dc["training_files"])
    rng = np.random.default_rng(seed)
    optimizer = torch.optim.Adam(model.parameters(),
                                 lr=float(tc["learning_rate"]),
                                 betas=(0.9, 0.999), eps=1e-8)
    compute_dtype = torch.bfloat16 if tc.get("fp16_run") else None
    step = make_step(model, wg_cfg, optimizer, float(tc.get("sigma", 1.0)),
                     compute_dtype)
    iters_per_checkpoint = int(tc.get("iters_per_checkpoint", 2000))

    out_dir = tc.get("output_directory", "outdir_waveglow")
    os.makedirs(out_dir, exist_ok=True)
    history = []
    iteration = 0
    t_last = time.time()
    for _ in range(int(tc.get("epochs", 1))):
        for _ in range(max(1, len(files) // batch_size)):
            mel, audio = sample_batch(rng, files, batch_size, seg, dc,
                                      ms.mel_numpy, rows)
            mel = torch.from_numpy(mel).to(device)
            audio = torch.from_numpy(audio).to(device)
            t0 = time.perf_counter()
            loss = float(step(mel, audio))          # waits for the step
            history.append({"iteration": iteration, "loss": loss,
                            "step_s": time.perf_counter() - t0})
            if lead:
                print(f"{iteration}:\t{loss:.6f}\t"
                      f"({time.time() - t_last:.2f}s)", flush=True)
            t_last = time.time()
            if lead and iteration % iters_per_checkpoint == 0:
                path = os.path.join(out_dir, f"waveglow_{iteration}.pt")
                tmp = f"{path}.{os.getpid()}.tmp"
                torch.save({"model": {k: v.detach().cpu() for k, v in
                                      model.state_dict().items()},
                            "config": wg_cfg}, tmp)
                os.replace(tmp, path)
            iteration += 1
    return model, wg_cfg, history


if __name__ == "__main__":
    main()
