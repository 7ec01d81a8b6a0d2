"""The two arithmetics the reference runs in.

``F64``: float64 throughout, the reference proper.

``TF32``: the control, the reference computed one precision below the
configurations' float32 with TF32 off: float32 storage, every operand of a
product rounded to TF32's 10 explicit mantissa bits, float32 sums (what a
tensor-core TF32 product does).  The control stands where the program
stands and has to come out as not correct.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value (10 mantissa bits, ties away from
    zero), still stored as float32."""
    if x.is_complex():
        return torch.complex(round_tf32(x.real.contiguous()),
                             round_tf32(x.imag.contiguous()))
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Arith(NamedTuple):
    name: str
    dtype: torch.dtype
    tf32: bool

    @property
    def cdtype(self) -> torch.dtype:
        return torch.complex128 if self.dtype == torch.float64 \
            else torch.complex64

    def op(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product, in this arithmetic."""
        x = x.to(self.cdtype if x.is_complex() else self.dtype)
        return round_tf32(x) if self.tf32 else x


F64 = Arith("float64", torch.float64, False)
TF32 = Arith("tf32", torch.float32, True)
