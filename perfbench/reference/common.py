"""Plain PyTorch pieces the references share: fp32 math with TF32 off, and the
one lower precision the control computes in.

Nothing here imports the port.  The references follow the model definitions
of the JAX package that the port was written from (and that its parity
tests hold it to): RMSNorm in fp32 scaled by ``1 + scale``, half-split
RoPE, SiLU gates, next-token cross-entropy over the masked tokens, and its
optimizer: global-norm clipping, then AdamW with ``b2`` 0.95, ``eps`` after
the square root, bias correction by ``step + 1`` and decay on every stored
leaf of two or more dimensions.

``precision`` is ``"fp32"`` (the reference) or ``"fp8"`` (the control):
with ``"fp8"`` every matrix product's operands are rounded to
``float8_e4m3fn`` with one scale a tensor (its largest magnitude at 448),
the step below the bfloat16 that the configurations compute in.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch

F32 = torch.float32
E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_fp32() -> Iterator[None]:
    """fp32 products in fp32: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 with one scale for the tensor, back in fp32.
    The rounding passes the gradient straight through, as fp8 training's
    casts do."""
    with torch.no_grad():
        scale = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
        rounded = (x / scale).to(torch.float8_e4m3fn).to(F32) * scale
    return x + (rounded - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in fp32, or on fp8-rounded operands for the control."""
    a, b = a.to(F32), b.to(F32)
    if precision == "fp8":
        a, b = fp8(a), fp8(b)
    elif precision != "fp32":
        raise ValueError(f"unknown precision {precision!r}")
    return a @ b


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.to(F32)
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale.to(F32))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding of x [..., L, H, hd] at positions 0..L-1."""
    l, hd = x.shape[-3], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=F32, device=x.device) / half)
    ang = torch.arange(l, dtype=F32, device=x.device)[:, None] * freqs
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def token_loss_sum(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
                   ) -> torch.Tensor:
    """Σ over positions of mask · (−log softmax(logits)[label])."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return ((lse - picked) * mask).sum()


def tree_items(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(tree_items(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)])
    return out


def set_path(tree: Dict, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


@torch.no_grad()
def clip_and_adamw(params: Dict, grads: Dict, opt: Dict, step: int, o: Dict
                   ) -> Tuple[Dict, Dict, Dict, float]:
    """One optimizer step of settings ``o`` (``lr``, ``b1``, ``b2``, ``eps``,
    ``weight_decay``, ``max_grad_norm``) from the 0-based ``step``.
    Returns (new params, new moments, the clipped gradients, the global
    norm before clipping)."""
    items = tree_items(grads)
    gnorm = math.sqrt(sum(float(g.double().square().sum()) for _, g in items))
    scale = min(o["max_grad_norm"] / max(gnorm, 1e-9), 1.0)
    c1 = 1.0 - o["b1"] ** (step + 1)
    c2 = 1.0 - o["b2"] ** (step + 1)
    new_p: Dict = {}
    new_m: Dict = {}
    new_v: Dict = {}
    clipped: Dict = {}
    for path, g in items:
        p = _get(params, path)
        m = _get(opt["m"], path) if opt else torch.zeros_like(p)
        v = _get(opt["v"], path) if opt else torch.zeros_like(p)
        g = g * scale
        m = o["b1"] * m + (1 - o["b1"]) * g
        v = o["b2"] * v + (1 - o["b2"]) * g.square()
        upd = (m / c1) / (torch.sqrt(v / c2) + o["eps"])
        if o["weight_decay"] and p.dim() >= 2:
            upd = upd + o["weight_decay"] * p
        set_path(new_p, path, p - o["lr"] * upd)
        set_path(new_m, path, m)
        set_path(new_v, path, v)
        set_path(clipped, path, g)
    return new_p, {"m": new_m, "v": new_v}, clipped, gnorm


def _get(tree: Dict, path: Tuple[str, ...]) -> torch.Tensor:
    for k in path:
        tree = tree[k]
    return tree


def train_step(loss_of_row, params: Dict, opt: Optional[Dict], step: int, dims: Dict,
               batch: Dict[str, torch.Tensor], o: Dict, precision: str
               ) -> Tuple[Dict, Dict, float, Dict, float]:
    """One training step from the 0-based ``step`` on the mean next-token
    loss over the batch's masked tokens: one row at a time
    (``loss_of_row(params, dims, tokens, labels, mask, precision)`` → its
    loss sum), the rows' gradients summed, then :func:`clip_and_adamw` with
    the moments ``opt`` (None: zero).  ``params`` are left as they were.
    Returns (new params, new moments, the loss, the clipped gradients, the
    global norm before clipping)."""
    with exact_fp32():
        items = tree_items(params)
        leaves = [t.detach().requires_grad_() for _, t in items]
        tree: Dict = {}
        for (path, _), t in zip(items, leaves):
            set_path(tree, path, t)
        count = batch["mask"].sum()
        grads = [torch.zeros_like(t) for t in leaves]
        total = 0.0
        for r in range(batch["tokens"].shape[0]):
            loss = loss_of_row(tree, dims, batch["tokens"][r], batch["labels"][r],
                               batch["mask"][r], precision) / count
            for acc, g in zip(grads, torch.autograd.grad(loss, leaves, allow_unused=True)):
                if g is not None:
                    acc += g
            total += float(loss.detach())
            del loss
        gtree: Dict = {}
        for (path, _), g in zip(items, grads):
            set_path(gtree, path, g)
        del leaves, tree, grads
        new_p, new_opt, clipped, gnorm = clip_and_adamw(params, gtree, opt, step, o)
    return new_p, new_opt, total, clipped, gnorm


def run_steps(loss_of_row, params: Dict, dims: Dict, batches: List[Dict[str, torch.Tensor]],
              o: Dict, precision: str) -> Dict:
    """The first ``len(batches)`` steps of :func:`train_step` from
    ``params`` (left as they were) and zero moments.  Returns the loss of each step,
    the first step's clipped gradients (what the optimizer got) and the
    parameters after the last step."""
    p, opt = params, None
    out: Dict = {"losses": []}
    for s, batch in enumerate(batches):
        p, opt, loss, clipped, gnorm = train_step(loss_of_row, p, opt, s, dims, batch, o,
                                                  precision)
        out["losses"].append(loss)
        if s == 0:
            out["grads"], out["grad_norm"] = clipped, gnorm
    out["params"] = p
    return out
