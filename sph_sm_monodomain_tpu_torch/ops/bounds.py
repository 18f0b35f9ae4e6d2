"""Axis-aligned bounding box (AABB) utilities (mirror of
`sph_sm_monodomain_tpu.ops.bounds`, `:27-90`; reference m3Bounds.h:9-99).

The simulation path uses only `clamp` (Update_Properties,
SPH_SM_monodomain.cpp:649); the rest is kept for API parity. Two reference
quirks are reproduced behind flags:

  - `contain` only tests x and y (m3Bounds.h:70-74 — a 2D leftover);
  - the offset variant of `clamp` also only handles x and y
    (m3Bounds.h:90-96).

Pass strict=False for the corrected 3D semantics.
"""

from __future__ import annotations

import dataclasses

import torch


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class Bounds:
    """AABB with (3,) min/max corners (m3Bounds.h:9-99)."""

    min: torch.Tensor
    max: torch.Tensor

    @classmethod
    def of(cls, lo, hi, device=None) -> "Bounds":
        return cls(min=_f32(lo, device), max=_f32(hi, device))

    @classmethod
    def empty(cls, device=None) -> "Bounds":
        """setEmpty (m3Bounds.h:33-37): min=+BOUNDS_MAX, max=-BOUNDS_MAX."""
        big = torch.full((3,), 3.4e38, dtype=torch.float32, device=device)
        return cls(min=big, max=-big)

    def is_empty(self) -> torch.Tensor:
        return torch.any(self.min > self.max)

    def combine(self, other: "Bounds") -> "Bounds":
        """Union (m3Bounds.h:55-58)."""
        return Bounds(min=torch.minimum(self.min, other.min),
                      max=torch.maximum(self.max, other.max))

    def intersect(self, other: "Bounds") -> "Bounds":
        """Intersection (m3Bounds.h:60-63)."""
        return Bounds(min=torch.maximum(self.min, other.min),
                      max=torch.minimum(self.max, other.max))

    def include(self, v) -> "Bounds":
        """Grow to include point(s) v (m3Bounds.h:65-68)."""
        v = torch.atleast_2d(_f32(v, self.min.device))
        return Bounds(min=torch.minimum(self.min, v.amin(dim=0)),
                      max=torch.maximum(self.max, v.amax(dim=0)))

    def contain(self, v, strict: bool = True) -> torch.Tensor:
        """Membership test. strict=True reproduces the reference's 2D
        leftover: only x and y are checked (m3Bounds.h:70-74)."""
        v = _f32(v, self.min.device)
        ok = (self.min <= v) & (v <= self.max)
        return torch.all(ok[..., :2], dim=-1) if strict \
            else torch.all(ok, dim=-1)

    def center(self) -> torch.Tensor:
        """getCenter (m3Bounds.h:81-83)."""
        return (self.min + self.max) * 0.5

    def clamp(self, pos: torch.Tensor) -> torch.Tensor:
        """Componentwise clamp into the box (m3Bounds.h:85-89) — the live
        call in Update_Properties (cpp:649). Empty boxes pass through."""
        clamped = torch.minimum(torch.maximum(pos, self.min), self.max)
        return torch.where(self.is_empty(), pos, clamped)

    def clamp_offset(self, pos: torch.Tensor, offset: float,
                     strict: bool = True) -> torch.Tensor:
        """Inset clamp. strict=True reproduces the 2D leftover: z is not
        clamped (m3Bounds.h:90-96)."""
        lo = self.min + offset
        hi = self.max - offset
        clamped = torch.minimum(torch.maximum(pos, lo), hi)
        if strict:
            clamped = torch.cat([clamped[..., :2], pos[..., 2:3]], dim=-1)
        return torch.where(self.is_empty(), pos, clamped)
