"""RAdam and the optimizer the training loop builds (port of
flowtron_tpu/train/radam.py and ``trainable_mask``,
flowtron_tpu/train/checkpoints.py:387).

RAdam keeps the reference's quirks (reference:radam.py:26-122), as the JAX
package does:
- rectification threshold N_sma >= 5; below it the update is the
  bias-corrected first moment with NO second-moment denominator;
- denom = sqrt(exp_avg_sq) + eps, the bias correction folded into the
  step size;
- decoupled weight decay ``-wd * lr * p`` on the pre-update p.
The step's scalars (beta2^t, N_sma, the rectifier) are computed as the
JAX package computes them (fp32 terms in t, Python-float constants), so
both take the same branch at the threshold and the same step size.

Gradient clipping is optax's ``clip_by_global_norm``: g unchanged when
||g|| < c, else (g / ||g||) * c, over the trainable parameters only. Over
a ``model`` axis each rank steps its slices (parallel/tensor_parallel.py)
and the norm is the whole one: the slices' squares summed over the model
group, plus the replicated leaves' counted once.
"""

import torch

from flowtron_tpu_torch.parallel.mesh import all_reduce_sum


class RAdam(torch.optim.Optimizer):
    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            scalars = {}                      # step -> (size, rectified)
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                m, v, g = state["exp_avg"], state["exp_avg_sq"], p.grad
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                if state["step"] not in scalars:
                    scalars[state["step"]] = _radam_scalars(state["step"],
                                                            b1, b2, lr)
                step_size, rectified = scalars[state["step"]]
                update = -step_size * m
                if rectified:
                    update.div_(v.sqrt() + eps)
                if wd != 0:
                    update.add_(p, alpha=-wd * lr)
                p.add_(update)
        return loss


def _radam_scalars(count, b1, b2, lr):
    """(step size, whether N_sma >= 5) for step ``count``. The terms in t
    are fp32 and the constants Python floats, in the JAX package's order
    of operations, so both round alike: near the threshold N_sma comes
    from a difference of two numbers ~2000 apart by ~5."""
    f = torch.float32
    t = torch.tensor(count, dtype=f)
    beta2_t = torch.tensor(b2, dtype=f) ** t
    n_sma_max = 2.0 / (1 - b2) - 1.0
    n_sma = n_sma_max - 2.0 * t * beta2_t / (1 - beta2_t)
    bias1 = 1 - torch.tensor(b1, dtype=f) ** t
    if bool(n_sma >= 5.0):
        rect = torch.sqrt(
            (1 - beta2_t) * (n_sma - 4) / (n_sma_max - 4)
            * (n_sma - 2) / n_sma * n_sma_max / (n_sma_max - 2))
        return float(lr * rect / bias1), True
    return float(lr / bias1), False


def trainable_parameters(model, finetune_layers=()):
    """[(name, parameter)] the optimizer may update: all of them, or, with
    a non-empty ``finetune_layers``, those whose name contains one of its
    substrings (reference:train.py:223-228). The rest are frozen
    (``requires_grad`` off), so they stay bitwise untouched."""
    out = []
    for name, p in model.named_parameters():
        keep = not finetune_layers or any(s in name for s in finetune_layers)
        p.requires_grad_(keep)
        if keep:
            out.append((name, p))
    return out


def build_optimizer(params, optim_algo, learning_rate, weight_decay=0.0):
    """RAdam, or Adam with torch's L2 weight decay on the gradient (the JAX
    package's ``add_decayed_weights`` + ``scale_by_adam``)."""
    if optim_algo == "RAdam":
        return RAdam(params, lr=learning_rate, weight_decay=weight_decay)
    if optim_algo == "Adam":
        return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=weight_decay)
    raise ValueError(f"Unrecognized optimizer {optim_algo!r}")


def _squares(grads, device):
    return sum((torch.linalg.vector_norm(g.float()) ** 2 for g in grads),
               torch.zeros((), device=device))


@torch.no_grad()
def clip_by_global_norm(params, max_norm, sharded=(), group=None):
    """optax's ``clip_by_global_norm`` on the gradients of ``params`` in
    place; returns the norm before clipping. ``sharded``: the parameters
    of ``params`` that are slices of a ``model`` axis whose ranks form
    ``group`` (a ``RankGroup``)."""
    grads = [p.grad for p in params if p.grad is not None]
    if sharded:
        ids = {id(p) for p in sharded}
        sliced = [p.grad for p in params
                  if p.grad is not None and id(p) in ids]
        whole = [p.grad for p in params
                 if p.grad is not None and id(p) not in ids]
        device = grads[0].device
        norm = torch.sqrt(all_reduce_sum(_squares(sliced, device), group)
                          + _squares(whole, device))
    else:
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float())
                         for g in grads]))
    if max_norm and max_norm > 0:
        for g in grads:
            g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm
