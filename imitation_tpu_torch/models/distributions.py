"""Action distributions: Categorical and DiagGaussian.

Port of ``imitation_tpu/models/distributions.py``. Sampling takes an explicit
``torch.Generator``; it does not reproduce ``jax.random``'s bits, so tests
compare log-probabilities and entropies, not samples.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass
class Categorical:
    """Categorical over the last axis of ``logits``."""

    logits: torch.Tensor  # [..., n]

    @property
    def log_probs_all(self) -> torch.Tensor:
        return F.log_softmax(self.logits, dim=-1)

    def log_prob(self, actions: torch.Tensor) -> torch.Tensor:
        lp = self.log_probs_all
        return torch.gather(lp, -1, actions.long().unsqueeze(-1)).squeeze(-1)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Gumbel-max sampling, as ``jax.random.categorical`` does."""
        u = torch.rand(
            self.logits.shape, generator=generator, device=self.logits.device
        ).clamp_(min=torch.finfo(torch.float32).tiny)
        return torch.argmax(self.logits - torch.log(-torch.log(u)), dim=-1)

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1)

    def entropy(self) -> torch.Tensor:
        lp = self.log_probs_all
        return -(torch.exp(lp) * lp).sum(dim=-1)


@dataclasses.dataclass
class DiagGaussian:
    """Diagonal Gaussian; log_prob sums over the last (action) axis."""

    mean: torch.Tensor  # [..., d]
    log_std: torch.Tensor  # [..., d] or [d] (state-independent)

    def _lstd(self) -> torch.Tensor:
        return self.log_std.expand_as(self.mean)

    def log_prob(self, actions: torch.Tensor) -> torch.Tensor:
        lstd = self._lstd()
        z = (actions - self.mean) * torch.exp(-lstd)
        per_dim = -0.5 * (z * z + _LOG_2PI) - lstd
        return per_dim.sum(dim=-1)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        eps = torch.randn(
            self.mean.shape, generator=generator, device=self.mean.device
        )
        return self.mean + eps * torch.exp(self._lstd())

    def mode(self) -> torch.Tensor:
        return self.mean

    def entropy(self) -> torch.Tensor:
        lstd = self._lstd()
        return (0.5 * (1.0 + _LOG_2PI) + lstd).sum(dim=-1)
