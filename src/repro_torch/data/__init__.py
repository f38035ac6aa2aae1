"""Synthetic science fields (paper Table I analogues)."""

from repro_torch.data.fields import make_field

__all__ = ["make_field"]
