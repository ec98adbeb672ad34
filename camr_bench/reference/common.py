"""The plain reference of a CAMR multi-model training step, shared by
every model family.

Plain PyTorch in float32 with TF32 off, written from the configuration
file alone: it imports nothing of the program. A family module beside
this one (``dense.py``, ``ssm.py``; found by the configuration's
``family``) gives the parameter layout and the forward pass to the loss.
This module gives what every family shares:

* the layout helpers (leaves in sorted-key order, the order in which the
  program lays the J parameter trees out as flat rows);
* :class:`Numerics`: every op computes in float32 (TF32 off), and the
  weights and every activation between ops are rounded to the
  configuration's ``dtype`` (the gradients flowing back through them
  too); the control also rounds each product's operands to float8 e4m3
  at a per-tensor scale;
* RMS norm, the chunk-free cross-entropy over the published vocabulary;
* :func:`train_steps`: J jobs, each a sum of N subfiles' gradients
  divided by N, clipped by its norm, then AdamW; it records what the
  check compares (each step's loss, the first gradient's leaf norms and
  the parameters' change).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

__all__ = ["Leaf", "flat_leaves", "Numerics", "rms_norm", "silu",
           "softplus", "nll_sum", "TrainRecord", "train_steps", "leaf_norms",
           "full_f32"]

#: the largest finite float8 e4m3 value
_E4M3_MAX = 448.0


@dataclass(frozen=True)
class Leaf:
    """One parameter of a model: its path in the tree, its shape, the
    dtype it is made and served in, and how it is initialised
    (``("normal", std)`` or ``("const", value)``)."""
    path: tuple
    shape: tuple
    dtype: str
    init: tuple

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def flat_leaves(tree: dict, prefix: tuple = ()) -> list:
    """The leaves of a nested dict in sorted-key order, depth first."""
    out = []
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out.extend(flat_leaves(val, prefix + (key,)))
        else:
            out.append(val)
    return out


def full_f32():
    """Switch off TF32 and reduced-precision reductions for the process:
    the reference's float32 is float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 at a per-tensor scale (its
    largest magnitude maps to 448); the gradient passes straight
    through."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = amax / _E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


@dataclass(frozen=True)
class Numerics:
    """The reference's precision: ``dtype`` is the configuration's (the
    weights' and activations' between ops); ``fp8`` makes the control,
    whose products take their operands through float8 e4m3 (the step
    below bfloat16)."""
    dtype: str
    fp8: bool = False

    def act(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` rounded to ``dtype`` and back (its gradient likewise)."""
        to = getattr(torch, self.dtype)
        return t if t.dtype == to else t.to(to).to(t.dtype)

    def inner(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` inside an op, its result kept in float32."""
        if self.fp8:
            a, b = _fp8(a), _fp8(b)
        return torch.matmul(a, b)

    def dense(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` as an op of its own: the result rounded to ``dtype``."""
        return self.act(self.inner(a, b))

    def weights(self, leaves: list, params: list) -> list:
        """Each parameter as the model reads it: rounded to its leaf's
        dtype."""
        return [p if leaf.dtype == "float32" else self.act(p)
                for leaf, p in zip(leaves, params)]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """``x / rms(x) * (1 + scale)`` over the last axis."""
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + scale)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` at every x."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def nll_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed negative log-likelihood of ``labels [b, T]`` (``-1``:
    ignored) under ``logits [b, T, vocab]``."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    return torch.where(labels >= 0, lse - gold, 0.0).sum()


def leaf_norms(values: list) -> torch.Tensor:
    """The L2 norm of each tensor, in float64 on the host."""
    return torch.stack([torch.linalg.vector_norm(v.double())
                        for v in values]).cpu()


@dataclass
class TrainRecord:
    """What the check compares, from either side: ``losses[s][j]`` the
    mean loss of job j's subfiles at step s; ``grad_norms[j][l]`` the
    norm of leaf l of job j's first gradient as AdamW takes it (summed
    over the subfiles, divided by N, clipped); ``delta_norms[j][l]`` the
    norm of leaf l's change after the recorded steps; ``params[j]`` the
    leaves after them, where kept."""
    losses: list
    grad_norms: torch.Tensor
    delta_norms: torch.Tensor
    params: list | None = None


def _subfile_grad(model, cfg, params, batch, num, rows):
    """Loss of one subfile (mean over its labelled tokens) and its
    gradient, the rows taken in blocks of ``rows``."""
    tokens, labels = batch["tokens"], batch["labels"]
    count = int((labels >= 0).sum())
    grads = [torch.zeros_like(p) for p in params]
    total = 0.0
    for r0 in range(0, tokens.shape[0], rows):
        nll = model.nll(cfg, params, tokens[r0:r0 + rows],
                        labels[r0:r0 + rows], num)
        part = torch.autograd.grad(nll / count, params)
        for g, p in zip(grads, part):
            g.add_(p)
        total += float(nll.detach())
    return total / count, grads


def train_steps(model, cfg: dict, init: list, feed, steps: int, *,
                fp8: bool = False, rows: int = 1, keep: bool = False,
                twin: bool = False) -> TrainRecord:
    """``steps`` CAMR training steps of the J models whose initial leaves
    are ``init[j]`` (each in flat order), on ``feed`` (the batch of job
    j's subfile n at step s is ``feed.batch(s * J * N + j * N + n)``).

    Job j's gradient is the sum of its N subfiles' gradients divided by
    N, each gradient and the sum rounded to ``cfg["grad_sync_dtype"]``
    (the precision the gradients are synced in); AdamW
    (``cfg["optimizer"]``) clips it by the norm of the whole row, then
    updates the moments and the parameters. ``model`` is the
    family module (``nll``), ``fp8`` makes the control, ``rows`` is the
    rows of a subfile taken at once; ``keep`` keeps the final
    parameters. ``twin`` computes every op in float64 with the same
    roundings to the configuration's dtypes: two sound computations of
    one step, which measure how far its stated precision lets any two
    apart (a look for calibration, never a run's check)."""
    camr, opt = cfg["camr"], cfg["optimizer"]
    q, k = camr["q"], camr["k"]
    J, N = q ** (k - 1), k
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    lr, wd, clip = opt["lr"], opt["weight_decay"], opt["max_grad_norm"]
    dev = init[0][0].device
    num = Numerics(cfg["dtype"], fp8)
    compute = torch.float64 if twin else torch.float32
    sync = Numerics(cfg["grad_sync_dtype"])
    losses = [[0.0] * J for _ in range(steps)]
    grad_norms, delta_norms, kept = [], [], []
    for j in range(J):
        params = [p.detach().to(compute).clone().requires_grad_(True)
                  for p in init[j]]
        mu = [torch.zeros_like(p) for p in params]
        nu = [torch.zeros_like(p) for p in params]
        for s in range(steps):
            gsum = [torch.zeros_like(p) for p in params]
            step_losses = []
            for n in range(N):
                batch = {key: torch.as_tensor(v, device=dev)
                         for key, v in feed.batch(s * J * N + j * N + n)
                         .items()}
                loss, grads = _subfile_grad(model, cfg, params, batch, num,
                                            rows)
                step_losses.append(loss)
                for acc, g in zip(gsum, grads):
                    acc.add_(sync.act(g))
            losses[s][j] = sum(step_losses) / N
            g = [sync.act(x) / N for x in gsum]
            gn = math.sqrt(sum(float(torch.sum(x.double() ** 2)) for x in g))
            scale = min(1.0, clip / max(gn, 1e-9))
            g = [x * scale for x in g]
            if s == 0:
                grad_norms.append(leaf_norms(g))
            t = s + 1
            with torch.no_grad():
                for p, m, v, x in zip(params, mu, nu, g):
                    m.mul_(b1).add_(x * (1 - b1))
                    v.mul_(b2).add_(x * x * (1 - b2))
                    delta = (m / (1 - b1 ** t)) / (
                        torch.sqrt(v / (1 - b2 ** t)) + eps)
                    p.sub_(lr * (delta + wd * p))
        delta_norms.append(leaf_norms([p.detach() - p0.to(compute)
                                       for p, p0 in zip(params, init[j])]))
        if keep:
            kept.append([p.detach() for p in params])
        del params, mu, nu
    return TrainRecord(losses, torch.stack(grad_norms),
                       torch.stack(delta_norms), kept if keep else None)
