"""Alignment and gate health metrics for validation (port of
``_isotonic_increasing``, ``attention_diagonality``,
``attention_monotonicity`` and ``gate_accuracy`` in
flowtron_tpu/train/evaluate.py:16-93).

The reference's de-facto health check is "attention looks diagonal"
(reference:README.md:37-40); these turn it into numbers the TensorBoard
logger writes beside the validation losses. Host numpy on the validation
batch's attention and gate logits. The standalone checkpoint evaluation
and tone-CER of the JAX module are not ported (ROADMAP.md Queue 1 (f)).
"""

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
