"""Synthetic datasets: skewed vectors (`vectors`) and tokens (`tokens`)."""

from repro_torch.data.tokens import SyntheticTokenDataset
