"""LearningBlock: the 3-layer MLP used for every neural function in GNS.

dim_in -> hidden -> hidden -> dim_out with LeakyReLU after the first two
layers and a linear output (reference GNS/main.py:17-31). The layers keep
the reference's names linear1/linear2/linear4 (there is no linear3), so a
reference state_dict loads with no renaming or transposing.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F


class LearningBlock(nn.Module):
    def __init__(self, dim_in: int, hidden_dim: int, dim_out: int,
                 negative_slope: float = 0.01):
        super().__init__()
        self.linear1 = nn.Linear(dim_in, hidden_dim)
        self.linear2 = nn.Linear(hidden_dim, hidden_dim)
        self.linear4 = nn.Linear(hidden_dim, dim_out)
        self.negative_slope = negative_slope

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """torch.nn.Linear's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in))
        for weight and bias, drawn from `generator`."""
        for lin in (self.linear1, self.linear2, self.linear4):
            bound = 1.0 / math.sqrt(lin.in_features)
            with torch.no_grad():
                lin.weight.uniform_(-bound, bound, generator=generator)
                lin.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.linear1(x), self.negative_slope)
        h = F.leaky_relu(self.linear2(h), self.negative_slope)
        return self.linear4(h)
