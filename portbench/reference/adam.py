"""Adam with a global-norm clip, as optax's ``chain(clip_by_global_norm,
adam)`` defines it, with the storage that the configuration states.

Arithmetic is float32 (``dtype`` float64 gives a float64 witness). A leaf
named in ``bf16`` is stored in bfloat16: its new value is rounded
stochastically (16 uniform random bits added below the bfloat16 mantissa,
then truncated, so the rounding is unbiased), and its two moments are
stored in bfloat16 by round-to-nearest-even. The random bits are
the reference's own (``generator``), not the program's: the comparison is of
norms, which agree in expectation whatever bits each side draws.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

Tensors = Dict[str, torch.Tensor]


def stochastic_bf16(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    noise = torch.randint(0, 1 << 16, x.shape, generator=generator, device=x.device,
                          dtype=torch.int32)
    return ((bits + noise) & -65536).view(torch.float32).to(torch.bfloat16)


class Adam:
    def __init__(self, params: Tensors, lr: float, cfg: dict, bf16: Iterable[str] = (),
                 generator: Optional[torch.Generator] = None, dtype=torch.float32):
        self.lr = float(lr)
        self.clip = float(cfg["grad_clip"])
        self.b1, self.b2, self.eps = (float(cfg["adam"][k]) for k in ("b1", "b2", "eps"))
        self.bf16 = set(bf16)
        self.gen = generator
        self.work = dtype
        self.m = {n: torch.zeros_like(t, dtype=self.dtype(n)) for n, t in params.items()}
        self.v = {n: torch.zeros_like(t, dtype=self.dtype(n)) for n, t in params.items()}
        self.count = 0

    def dtype(self, name: str) -> torch.dtype:
        return torch.bfloat16 if name in self.bf16 else self.work

    @torch.no_grad()
    def step(self, params: Tensors, grads: Tensors) -> Tensors:
        """New parameter values in the working type (bfloat16 values for
        ``bf16`` leaves, held in it); ``params`` is not changed."""
        w = self.work
        norm = torch.sqrt(sum(g.to(w).square().sum() for g in grads.values()))
        scale = torch.clamp(self.clip / (norm + 1e-12), max=1.0)
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        out = {}
        for n, p in params.items():
            g = grads[n].to(w) * scale
            m = self.b1 * self.m[n].to(w) + (1 - self.b1) * g
            v = self.b2 * self.v[n].to(w) + (1 - self.b2) * g * g
            new = p.to(w) - self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps)
            self.m[n] = m.to(self.dtype(n))
            self.v[n] = v.to(self.dtype(n))
            out[n] = stochastic_bf16(new, self.gen).to(w) if n in self.bf16 else new
        return out

    def first_gradient(self, name: str) -> torch.Tensor:
        """The clipped gradient the first step saw, from its first moment."""
        return self.m[name].to(self.work) / (1 - self.b1)
