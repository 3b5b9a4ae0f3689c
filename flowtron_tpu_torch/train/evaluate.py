"""Checkpoint evaluation and the validation health metrics (port of
flowtron_tpu/train/evaluate.py).

The reference reports validation loss only inside its training loop
(reference:train.py:142-202), and its invertibility oracle did not run
as shipped (reference:flowtron.py:932-954). ``evaluate`` checks any
``.pt`` checkpoint without training: the nll / gate / ctc decomposition
over the validation filelist, three alignment and gate health means,
optional ``attention.png`` / ``gate.png``, the tone-CER of
``data/tone_cer.py`` on a coded-tone corpus, and the invertibility
round trip. The health metrics (``attention_diagonality``,
``attention_monotonicity``, ``gate_accuracy``) turn the reference's
"attention looks diagonal" check (reference:README.md:37-40) into
numbers; host numpy, also written by the TensorBoard logger.
"""

import contextlib

import numpy as np


def _isotonic_increasing(y):
    """L2 isotonic regression (pool-adjacent-violators): the best
    non-decreasing fit to y. Pure numpy, O(n)."""
    vals, wts = [], []
    for v in np.asarray(y, np.float64):
        vals.append(float(v))
        wts.append(1)
        while len(vals) > 1 and vals[-2] > vals[-1]:
            v2, w2 = vals.pop(), wts.pop()
            v1, w1 = vals.pop(), wts.pop()
            vals.append((v1 * w1 + v2 * w2) / (w1 + w2))
            wts.append(w1 + w2)
    out = np.empty(len(y))
    i = 0
    for v, w in zip(vals, wts):
        out[i:i + w] = v
        i += w
    return out


def attention_diagonality(attn, out_lens, in_lens, band=0.12):
    """Mean attention mass within +-band of the ideal diagonal (mel frame
    t attends near text position t * T_text / T_mel), over valid frames
    and positions, in [0, 1]. attn (B, T_mel, T_text)."""
    attn = np.asarray(attn)
    scores = []
    for b in range(attn.shape[0]):
        O, I = int(out_lens[b]), int(in_lens[b])
        if O < 2 or I < 2:
            continue
        A = attn[b, :O, :I].astype(np.float64)
        A /= np.maximum(A.sum(-1, keepdims=True), 1e-8)
        t = np.arange(O)[:, None] / (O - 1)
        k = np.arange(I)[None, :] / (I - 1)
        r = max(band, 2.0 / I)  # never narrower than ~2 text positions
        scores.append(float((A * (np.abs(k - t) <= r)).sum() / O))
    return float(np.mean(scores)) if scores else 0.0


def attention_monotonicity(attn, out_lens, in_lens):
    """1 - normalized deviation of the attention centroid E[text pos | mel
    frame] from its best monotone (isotonic) fit: 1.0 when the alignment
    only moves forward through the text."""
    attn = np.asarray(attn)
    scores = []
    for b in range(attn.shape[0]):
        O, I = int(out_lens[b]), int(in_lens[b])
        if O < 2 or I < 2:
            continue
        A = attn[b, :O, :I].astype(np.float64)
        A /= np.maximum(A.sum(-1, keepdims=True), 1e-8)
        c = (A * np.arange(I)).sum(-1)
        dev = np.mean(np.abs(c - _isotonic_increasing(c))) / max(I - 1, 1)
        scores.append(1.0 - min(1.0, float(dev)))
    return float(np.mean(scores)) if scores else 0.0


def gate_accuracy(gate_logits, gate_target, out_lens):
    """Fraction of valid frames (t < out_len) where sigmoid(logit) > 0.5
    matches the target. gate_logits (T, B, 1), gate_target (B, T)."""
    gp = np.asarray(gate_logits)[:, :, 0].T  # (T, B, 1) -> (B, T)
    gt = np.asarray(gate_target)
    correct, total = 0, 0
    for b in range(gt.shape[0]):
        O = int(out_lens[b])
        pred = gp[b, :O] > 0.0
        correct += int((pred == (gt[b, :O] > 0.5)).sum())
        total += O
    return correct / max(total, 1)


def _save_plots(last, out_dir):
    """``attention.png`` (the last flow's alignment of the batch's first
    utterance) and ``gate.png`` for the last validation batch, without
    TensorBoard."""
    import os
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.image as mpimg
    from flowtron_tpu_torch.train.logger import (
        _numpy, plot_alignment_to_numpy, plot_gate_outputs_to_numpy)

    os.makedirs(out_dir, exist_ok=True)
    attn = _numpy(last["attn"]).astype(np.float32)   # (B, T_mel, T_text)
    mpimg.imsave(os.path.join(out_dir, "attention.png"),
                 plot_alignment_to_numpy(attn[0].T))
    gp = _numpy(last["gate_pred"]).astype(np.float32)  # (T, B, 1)
    probs = 1.0 / (1.0 + np.exp(-gp[:, 0, 0]))
    batch = last.get("batch") or {}
    targets = (np.asarray(batch["gate_target"])[0, :probs.shape[0]]
               if batch.get("gate_target") is not None
               else np.zeros_like(probs))
    mpimg.imsave(os.path.join(out_dir, "gate.png"),
                 plot_gate_outputs_to_numpy(targets, probs))


@contextlib.contextmanager
def tf32_off():
    """fp32 matmuls and cuDNN without TF32 inside the block (the oracle's
    ~1e-6 needs full fp32 on the card); the flags are restored after."""
    import torch
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def evaluate(config, checkpoint_path, invertibility_frames=100,
             seed=1234, plots_dir=None, tone_cer_texts=0, device=None):
    """Returns a dict: the validation loss decomposition (loss, nll,
    gate, ctc), the means of the three health metrics over the
    validation batches, ``tone_cer`` and ``tone_cer_mel`` when
    ``tone_cer_texts`` > 0 (that many validation transcripts, each
    synthesized and decoded), and ``invertibility_err`` when
    ``invertibility_frames`` > 0 (the round trip of a seeded latent of
    that many frames with the first validation utterance's text and
    speaker). With ``plots_dir``, writes attention.png and gate.png for
    the last validation batch.

    Reads a ``.pt`` checkpoint (a training checkpoint or a reference
    state_dict), a JAX package pickle, sharded or orbax checkpoint, or the
    port's checkpoint directory (``infer/sampling.py:
    load_model_for_inference``); runs on ``cuda:0`` unless ``device`` or
    ``FLOWTRON_PLATFORM=cpu`` asks for the CPU.
    """
    import torch
    from flowtron_tpu_torch.infer.sampling import load_model_for_inference
    from flowtron_tpu_torch.models.flowtron import (
        flowtron_test_invertibility)
    from flowtron_tpu_torch.train.loop import (
        compute_validation_loss, make_eval_step, prepare_dataloaders)
    from flowtron_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    train_config = config["train_config"]
    model, static_cfg = load_model_for_inference(config, checkpoint_path,
                                                 device)
    # validation as in training, with CTC whenever the config trains with
    # it (its start iteration concerns training; a checkpoint is past it)
    eval_step = make_eval_step(model, static_cfg, train_config)
    _, val_loader = prepare_dataloaders(
        dict(config["data_config"]), int(train_config["batch_size"]),
        seed=seed)
    ctc_w = (float(train_config.get("ctc_loss_weight", 0.0))
             if train_config.get("use_ctc_loss") else 0.0)

    qual = {"attn_diagonality": [], "attn_monotonicity": [],
            "gate_accuracy": []}

    def on_batch(out, batch):
        attn = out["attn"].float().cpu().numpy()
        qual["attn_diagonality"].append(attention_diagonality(
            attn, batch["out_lens"], batch["in_lens"]))
        qual["attn_monotonicity"].append(attention_monotonicity(
            attn, batch["out_lens"], batch["in_lens"]))
        qual["gate_accuracy"].append(gate_accuracy(
            out["gate_pred"].float().cpu().numpy(), batch["gate_target"],
            batch["out_lens"]))

    totals, last = compute_validation_loss(eval_step, val_loader, device,
                                           ctc_w, on_batch=on_batch)
    result = dict(totals)
    for k, v in qual.items():
        if v:
            result[k] = float(np.mean(v))
    if plots_dir and last is not None:
        _save_plots(last, plots_dir)

    if tone_cer_texts and tone_cer_texts > 0:
        from flowtron_tpu_torch.data.tone_cer import tone_cer_report
        report = tone_cer_report(config, model, static_cfg,
                                 max_texts=int(tone_cer_texts), seed=seed)
        result["tone_cer"] = report["tone_cer"]
        result["tone_cer_mel"] = report["tone_cer_mel"]

    if invertibility_frames and invertibility_frames > 0:
        batch = next(iter(val_loader))
        T_in = int(batch["in_lens"][0])
        text = torch.from_numpy(batch["text"][:1, :max(1, T_in)]).to(device)
        sid = torch.from_numpy(batch["speaker_ids"][:1]).to(device)
        n_mel = int(static_cfg["n_mel_channels"])
        sigma = float(train_config.get("sigma", 1.0))
        g = torch.Generator().manual_seed(seed)
        residual = (sigma * torch.randn(1, n_mel, int(invertibility_frames),
                                        generator=g)).to(device)
        with tf32_off():
            err = flowtron_test_invertibility(model, static_cfg, residual,
                                              sid, text)
        result["invertibility_err"] = float(err)
    return result
