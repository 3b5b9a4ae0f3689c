"""Flowtron training losses: masked NLL, gate BCE, CTC alignment loss
(port of flowtron_tpu/train/loss.py; reference:flowtron.py:155-275).

- NLL = sum(z^2 * mask) / (2 sigma^2) - sum_i sum(log_s_i * mask),
  normalised by n_valid_frames * n_mel; with the Gaussian-mixture head,
  the mixture's negative log-likelihood of z (a log-sum-exp over the
  components) in place of the first term.
- Gate: BCE with logits, masked, normalised by n_valid_frames.
- CTC over the attention log-posterior with a prepended blank column,
  target sequence 1..key_len, per-sample loss divided by key_len, averaged
  over the batch and the flows; backward-flow log-posteriors are un-flipped
  first. optax's ``ctc_loss`` normalises its logits itself and
  ``F.ctc_loss`` does not, so the port takes ``log_softmax`` first.

Every loss is computed in fp32 whatever the compute dtype.

In a data-parallel step each rank holds a slice of the global batch and
passes ``norm``, the global batch's (valid frames, rows): each of its
losses is then its slice's sums over the global counts, and the ranks'
losses (and gradients) sum to the global batch's, as JAX's one program
computes them over the whole batch. Averaging the ranks' own means
instead would weigh a rank's frames by its share of the frames.
"""

import torch
import torch.nn.functional as F

from flowtron_tpu_torch.utils.masks import (
    flip_time_batch_major, sequence_mask,
)


def attention_ctc_loss(attn_logprob, in_lens, out_lens, blank_logprob=-1.0,
                       n_rows=None):
    """CTC alignment loss for one flow. attn_logprob (B, T_mel, T_text)
    pre-softmax log-posterior. Returns the batch mean of per-sample CTC
    NLL / key_len (the sum over ``n_rows`` rows where given)."""
    B, T, Tk = attn_logprob.shape
    logits = F.pad(attn_logprob.float(), (1, 0), value=blank_logprob)
    # classes past key_len + 1 take no part (the reference slices them off)
    class_ids = torch.arange(Tk + 1, device=logits.device)
    logits = logits.masked_fill(
        class_ids[None, None, :] > in_lens[:, None, None], -1e9)
    log_probs = torch.log_softmax(logits, dim=-1).transpose(0, 1)
    targets = torch.arange(1, Tk + 1, device=logits.device).expand(B, Tk)
    per_seq = F.ctc_loss(log_probs, targets, out_lens, in_lens, blank=0,
                         reduction="none", zero_infinity=True)
    # as the JAX package's optax path: an impossible alignment scores 0
    per_seq = torch.where(per_seq < 1e5, per_seq, 0.0)
    per_seq = per_seq / in_lens.to(per_seq.dtype)
    return per_seq.mean() if n_rows is None else per_seq.sum() / n_rows


def gaussian_mixture_nll(z, mask, mean, log_var, prob):
    """-sum over valid frames of log sum_k prob_k N(z; mean_k, exp(log_var_k))
    without the 2 pi term, as the reference: z (T, B, M) against mean and
    log_var (1 or B, M, K) and prob (B, K), in fp32 through a
    log-sum-exp. ``amax`` shares the gradient among tied maxima, as
    JAX's ``max`` does (fixed means tie in every channel they leave 0)."""
    zk = z[..., None]                                          # (T,B,M,1)
    mean_b, log_var_b = mean.float()[None], log_var.float()[None]
    prob_b = prob.float()[None, :, None, :]                    # (1,B,1,K)
    _z = -(zk - mean_b) ** 2 / (2.0 * torch.exp(log_var_b))
    _zmax = torch.amax(_z, dim=3, keepdim=True)
    _z = prob_b * torch.exp(_z - _zmax) / torch.sqrt(torch.exp(log_var_b))
    _z = _zmax + torch.log(_z.sum(dim=3, keepdim=True))
    return -(mask[..., None] * _z).sum()


def flowtron_loss(model_output, gate_target, in_lens, out_lens, sigma=1.0,
                  gm_loss=False, gate_loss=True, use_ctc_loss=False,
                  blank_logprob=-1.0, norm=None):
    """(nll, gate, ctc) from ``flowtron_forward``'s output.
    gate_target: (B, T), 1.0 from the last real frame onward. ``norm``:
    the (valid frames, rows) to divide by, as a (2,) tensor; this batch's
    own by default."""
    (z, log_s_list, gate_pred, _, attn_logprob_list,
     mean, log_var, prob) = model_output
    z = z.float()
    T, B, n_mel = z.shape
    mask = sequence_mask(out_lens, T).t()[..., None].to(z.dtype)  # (T,B,1)
    n_elements = mask.sum() if norm is None else norm[0]
    log_s_total = sum((log_s.float() * mask).sum() for log_s in log_s_list)
    if gm_loss:
        loss_nll = gaussian_mixture_nll(z, mask, mean, log_var, prob) \
            - log_s_total
    else:
        zm = z * mask
        loss_nll = (zm * zm).sum() / (2.0 * sigma * sigma) - log_s_total
    loss_nll = loss_nll / (n_elements * n_mel)

    loss_gate = z.new_zeros(())
    if gate_loss and gate_pred is not None:
        gp = (gate_pred.float() * mask)[..., 0].t()               # (B, T)
        bce = F.binary_cross_entropy_with_logits(
            gp, gate_target.float(), reduction="none")
        loss_gate = (bce * mask[..., 0].t()).sum() / n_elements

    loss_ctc = z.new_zeros(())
    if use_ctc_loss:
        for i, attn_logprob in enumerate(attn_logprob_list):
            if i % 2 != 0:
                attn_logprob = flip_time_batch_major(attn_logprob, out_lens)
            loss_ctc = loss_ctc + attention_ctc_loss(
                attn_logprob, in_lens, out_lens, blank_logprob,
                None if norm is None else norm[1])
        loss_ctc = loss_ctc / float(len(attn_logprob_list))
    return loss_nll, loss_gate, loss_ctc
