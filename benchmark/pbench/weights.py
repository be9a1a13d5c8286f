"""Checkpoint tensors of a configuration, drawn from a seed on the card.

The layout is the configuration's own: its reference module
(``references/<reference_impl>.py``) gives ``leaf_specs(config)``, every
checkpoint tensor as ``(name, shape, kind, scale, offset)``, and
``CHECKPOINT_DTYPE``, the dtype the tensors are held in. A leaf's value is
``offset + scale · draw`` where kind ``"n"`` draws N(0, 1), ``"u"`` draws
U[0, 1), ``"e"`` is ``exp(scale · U)`` and ``"c"`` is the constant
``offset``.

The draws come from one ``torch.Generator`` on ``device`` seeded with
``seed``: first the normal stream, every ``"n"`` leaf in the layout's order,
then the uniform stream, every ``"u"`` and ``"e"`` leaf; each stream drawn
in consecutive chunks of at most :data:`CHUNK` elements, in float32. A set
whose streams each fit one chunk is made in two launches. Each leaf is
written straight into its own tensor in the checkpoint's dtype, so the
card holds the set in that dtype, one chunk, and one leaf's float32 values.
"""

from __future__ import annotations

import math
from types import ModuleType
from typing import Dict

import torch

__all__ = ["CHUNK", "make_weights", "weight_count"]

# The most elements one draw makes: 4.3 GB of float32.
CHUNK = 2**30


def weight_count(layout: ModuleType, config: Dict) -> int:
    return sum(math.prod(shape) for _n, shape, _k, _s, _o in layout.leaf_specs(config))


class _Stream:
    """``total`` values drawn ``CHUNK`` at a time by ``draw(n)``, handed out
    in order; one chunk alive at a time."""

    def __init__(self, draw, total: int) -> None:
        self.draw, self.left = draw, total
        self.chunk, self.pos = None, 0

    def piece(self, want: int) -> torch.Tensor:
        """At most ``want`` of the next values: a view of the chunk."""
        if self.chunk is None or self.pos == self.chunk.numel():
            self.chunk = None  # freed before the next is drawn
            n = min(CHUNK, self.left)
            self.chunk, self.pos, self.left = self.draw(n), 0, self.left - n
        out = self.chunk[self.pos : self.pos + want]
        self.pos += out.numel()
        return out


def _fill(out: torch.Tensor, stream: _Stream, kind: str, scale: float, offset: float) -> None:
    """Write ``out`` (any dtype) from the stream's next ``out.numel()``
    values, a piece at a time, through float32."""
    flat = out.view(-1)
    done = 0
    while done < flat.numel():
        v = stream.piece(flat.numel() - done) * scale
        if kind == "e":
            v.exp_()
        else:
            v.add_(offset)
        flat[done : done + v.numel()].copy_(v)
        done += v.numel()


def make_weights(layout: ModuleType, config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``{checkpoint name: tensor on device}`` of ``config`` in the layout's
    ``CHECKPOINT_DTYPE``, from ``seed``."""
    specs = layout.leaf_specs(config)
    dtype = getattr(torch, layout.CHECKPOINT_DTYPE)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out: Dict[str, torch.Tensor] = {}
    streams = [
        (("n",), lambda n: torch.randn(n, generator=gen, device=device, dtype=torch.float32)),
        (("u", "e"), lambda n: torch.rand(n, generator=gen, device=device, dtype=torch.float32)),
    ]
    for kinds, draw in streams:
        mine = [s for s in specs if s[2] in kinds]
        stream = _Stream(draw, sum(math.prod(shape) for _n, shape, _k, _s, _o in mine))
        for name, shape, kind, scale, offset in mine:
            out[name] = torch.empty(shape, dtype=dtype, device=device)
            _fill(out[name], stream, kind, scale, offset)
        del stream
    for name, shape, kind, _scale, offset in specs:
        if kind == "c":
            out[name] = torch.full(shape, offset, dtype=dtype, device=device)
    return {name: out[name] for name, *_ in specs}
