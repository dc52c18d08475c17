"""Sequence parallelism: NCSN++ activations split along the frame axis
(T, the last axis of NCHW) over k devices, with explicit halo exchange and
cross-shard reductions (the counterpart of what XLA's SPMD partitioner
inserts for the reference's `spec_sharding_constraint`,
storm_tpu/models/base.py:156-183).

A `Sharded` activation is k tensors (B, C, F, T_i), part i on device i of
its group (a device may repeat: k shards on one card). The boundaries come
from the net's coarsest level and are scaled by 2^level (`frame_widths`),
so that every level's boundaries line up under the FIR down- and
up-sampling; parts may be unequal (ncsnpplarge's bottleneck holds 9 frames
of a 576-frame bucket).

The primitives:

- `Sharded.halo_map(fn, halo, scale)`: each part with `halo` frames of its
  neighbours on either side (taken from as many shards as that needs, so a
  level narrower than its halo is still right; zeros at the global edges,
  the padding the op adds itself), `fn` on it, then the output's frames that
  belong to the halo cropped (halo * scale of them each side, `scale` the
  op's frame ratio: 1, 2 or 1/2), contiguous. A "same" conv takes a halo of
  (k - 1) / 2 frames, the FIR resamplers a halo of 2 (even, so that a
  stride-2 op keeps its phase).
- `group_norm_moments`: the group means, then the variances around them,
  over all shards in float32 (the two-pass form of the unsharded GroupNorm;
  nn/layers.GroupNorm then normalizes each shard in float32, one rounding).
- `attention_gathered`: each shard's queries against every shard's keys
  and values, gathered in frame order, so that each logit is the dot
  product of the unsharded attention.
- Elementwise ops (arithmetic with scalars, per-row tensors or another
  `Sharded` of the same boundaries, the activations, dropout, `.to(dtype)`)
  run per part; `torch.cat` joins channels (dim 1) per part. Any other
  torch function on a `Sharded` raises NotImplementedError: nothing falls
  back to a gathered tensor unseen.

The layers dispatch on a `Sharded` input themselves (nn/layers.py,
nn/qconv.py); a layer's parameters for part i are those of the replica of
the net that part i's device holds (`ShardContext.module`).
"""
from __future__ import annotations

import copy
import operator
from typing import Callable, Dict, List, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from .cast import scalar


def frame_widths(T: int, levels: int, k: int) -> List[int]:
    """The k shards' widths at the top level of a net of `levels` levels on
    T frames: the coarsest level's T / 2^(levels - 1) frames split as evenly
    as they go (the first shards one frame wider), each scaled by
    2^(levels - 1)."""
    f = 2 ** (levels - 1)
    if T % f:
        raise ValueError(f"{T} frames do not halve {levels - 1} times")
    coarse = T // f
    if coarse < k:
        raise ValueError(f"seq_parallel={k}: the coarsest level holds {coarse} frames, fewer "
                         "than the shards")
    base, extra = divmod(coarse, k)
    return [(base + (i < extra)) * f for i in range(k)]


def scatter(x: torch.Tensor, widths: Sequence[int], devices: Sequence[torch.device],
            dim: int) -> List[torch.Tensor]:
    """x cut along `dim` into parts of `widths`, each contiguous on its device."""
    parts, start = [], 0
    for w, dev in zip(widths, devices):
        parts.append(x.narrow(dim, start, w).contiguous().to(dev))
        start += w
    if start != x.shape[dim]:
        raise ValueError(f"shard widths {list(widths)} do not cover {x.shape[dim]} frames")
    return parts


def gather(parts: Sequence[torch.Tensor], device: torch.device, dim: int) -> torch.Tensor:
    """The parts joined along `dim` on `device`."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


def replica(module: nn.Module, device: torch.device) -> nn.Module:
    """A copy of `module` on `device` for inference, holding none of the
    per-call state of the original (cast copies, attached int8 scales,
    sharded wrappers): those are attached to the copy per call."""
    from .qconv import QuantizableConv

    dup = copy.deepcopy(module)
    for m in dup.modules():
        m.__dict__.pop("_cast", None)
        m.__dict__.pop("_seq_parallel", None)
        if isinstance(m, QuantizableConv):
            m.set_scale(None)
    dup.requires_grad_(False)
    return dup.to(device)


@torch.no_grad()
def copy_weights_(dst: nn.Module, src: nn.Module) -> None:
    """`src`'s parameters and buffers into `dst`'s, a replica of the same structure."""
    for d, s in zip(list(dst.parameters()) + list(dst.buffers()),
                    list(src.parameters()) + list(src.buffers())):
        d.copy_(s)


class ShardContext:
    """What the shards of one sharded net share: their devices, and for each
    of the net's modules the module part i runs (the net's own, or its
    counterpart in `nets[i]`, a replica on part i's device)."""

    def __init__(self, devices: Sequence[torch.device], net: nn.Module,
                 nets: Sequence[nn.Module]):
        self.devices = [torch.device(d) for d in devices]
        self._per_part: Dict[int, List[nn.Module]] = {}
        if any(r is not net for r in nets):
            copies = [list(r.modules()) for r in nets]
            for j, m in enumerate(net.modules()):
                self._per_part[id(m)] = [c[j] for c in copies]

    def module(self, m: nn.Module, i: int) -> nn.Module:
        """The module part i runs for the net's module `m`."""
        per_part = self._per_part.get(id(m))
        return m if per_part is None else per_part[i]


Operand = Union["Sharded", torch.Tensor, float, int]


class Sharded:
    """An activation split along its last (frame) axis into parts on the
    devices of a `ShardContext` (module docstring)."""

    __slots__ = ("parts", "ctx")

    def __init__(self, parts: Sequence[torch.Tensor], ctx: ShardContext):
        self.parts = list(parts)
        self.ctx = ctx

    def _like(self, parts) -> "Sharded":
        return Sharded(parts, self.ctx)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def widths(self) -> List[int]:
        return [p.shape[-1] for p in self.parts]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Sharded":
        return self._like([fn(p) for p in self.parts])

    def to(self, *args, **kwargs) -> "Sharded":
        return self.map(lambda p: p.to(*args, **kwargs))

    def contiguous(self) -> "Sharded":
        return self.map(lambda p: p.contiguous())

    # --- elementwise arithmetic ------------------------------------------

    def _operand(self, other: Operand, i: int):
        if isinstance(other, Sharded):
            return other.parts[i]
        if isinstance(other, torch.Tensor):  # a per-row tensor: a copy on each device
            return other.to(self.parts[i].device)
        return other

    def _binary(self, other: Operand, op, reverse: bool = False) -> "Sharded":
        if isinstance(other, Sharded) and other.widths != self.widths:
            raise ValueError(f"shards of widths {self.widths} and {other.widths}")
        if not isinstance(other, (Sharded, torch.Tensor, float, int)):
            return NotImplemented
        out = []
        for i, p in enumerate(self.parts):
            o = self._operand(other, i)
            out.append(op(o, p) if reverse else op(p, o))
        return self._like(out)

    def __add__(self, o): return self._binary(o, operator.add)
    def __radd__(self, o): return self._binary(o, operator.add, True)
    def __sub__(self, o): return self._binary(o, operator.sub)
    def __rsub__(self, o): return self._binary(o, operator.sub, True)
    def __mul__(self, o): return self._binary(o, operator.mul)
    def __rmul__(self, o): return self._binary(o, operator.mul, True)
    def __truediv__(self, o): return self._binary(o, operator.truediv)

    ELEMENTWISE = (F.silu, F.relu, F.elu, F.leaky_relu, F.dropout)  # NCSN++'s activations

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.cat:
            seq = list(args[0])
            dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
            if dim != 1 or not all(isinstance(s, Sharded) for s in seq):
                raise NotImplementedError("torch.cat of frame-sharded activations: channels "
                                          "(dim=1) of sharded operands only")
            if any(s.widths != seq[0].widths for s in seq):
                raise ValueError("torch.cat of shards of different widths")
            return seq[0]._like([torch.cat([s.parts[i] for s in seq], dim=1)
                                 for i in range(len(seq[0].parts))])
        rest = list(args[1:]) + list(kwargs.values())
        if (func in cls.ELEMENTWISE and isinstance(args[0], Sharded)
                and not any(isinstance(a, Sharded) for a in rest)):
            return args[0].map(lambda p: func(p, *args[1:], **kwargs))
        raise NotImplementedError(f"{getattr(func, '__name__', func)} on frame-sharded "
                                  "activations")

    # --- halo exchange ---------------------------------------------------

    def with_halo(self, i: int, halo: int) -> torch.Tensor:
        """Part i with `halo` frames on either side, from its neighbours
        (as many as that takes), zeros past the global edges."""
        p = self.parts[i]
        if halo == 0:
            return p
        sides = []
        for step in (-1, 1):
            pieces, need, j = [], halo, i + step
            while need and 0 <= j < len(self.parts):
                q = self.parts[j]
                take = min(need, q.shape[-1])
                piece = q[..., q.shape[-1] - take:] if step < 0 else q[..., :take]
                pieces.append(piece.to(p.device))
                need -= take
                j += step
            if need:
                pieces.append(p.new_zeros(p.shape[:-1] + (need,)))
            sides.append(pieces[::-1] if step < 0 else pieces)
        return torch.cat(sides[0] + [p] + sides[1], dim=-1)

    def halo_map(self, fn: Callable[[int, torch.Tensor], torch.Tensor], halo: int,
                 scale: float = 1.0) -> "Sharded":
        """fn(i, part i with its halo) per part, each output cropped by
        halo * scale frames on either side, contiguous (module docstring)."""
        crop = halo * scale
        if crop != int(crop):
            raise ValueError(f"a halo of {halo} frames at scale {scale} crops a fraction")
        crop = int(crop)
        out = []
        for i, p in enumerate(self.parts):
            y = fn(i, self.with_halo(i, halo))
            if y.shape[-1] != (p.shape[-1] + 2 * halo) * scale:
                raise RuntimeError(f"a sharded op gave {y.shape[-1]} frames for "
                                   f"{p.shape[-1]} + 2 x {halo} at scale {scale}")
            out.append((y[..., crop: y.shape[-1] - crop] if crop else y).contiguous())
        return self._like(out)

    def apply(self, module: nn.Module, halo: int = 0, scale: float = 1.0) -> "Sharded":
        """`module` (part i's replica of it) by `halo_map`."""
        return self.halo_map(lambda i, t: self.ctx.module(module, i)(t), halo, scale)


# --- cross-shard reductions ------------------------------------------------


def group_norm_moments(x: Sharded, groups: int):
    """(mean, var), each (B, G) float32 on the first part's device: the group
    means over all shards, then the mean squared deviation from them."""
    B = x.parts[0].shape[0]
    home = x.parts[0].device
    grouped = [p.reshape(B, groups, -1) for p in x.parts]
    n = sum(g.shape[-1] for g in grouped)
    mean = sum(g.float().sum(dim=-1).to(home) for g in grouped) / n
    var = sum((g.float() - mean.to(g.device)[:, :, None]).square().sum(dim=-1).to(home)
              for g in grouped) / n
    return mean, var


def attention_gathered(q: Sharded, k: Sharded, v: Sharded) -> Sharded:
    """Single-head attention of each shard's queries over every position of
    the unsharded activation, with the unsharded AttnBlockpp's roundings:
    the logits in the compute dtype times C^-0.5 in it, the softmax in
    float32, its weights rounded before the second product."""
    out = []
    for qi in q.parts:
        B, C = qi.shape[:2]
        dev = qi.device
        keys = gather(k.parts, dev, -1).reshape(B, C, -1)
        values = gather(v.parts, dev, -1).reshape(B, C, -1)
        logits = torch.einsum("bcq,bck->bqk", qi.reshape(B, C, -1), keys) \
            * scalar(int(C) ** (-0.5), qi.dtype)
        w = torch.softmax(logits.float(), dim=-1).to(qi.dtype)
        out.append(torch.einsum("bqk,bck->bcq", w, values).reshape(qi.shape))
    return q._like(out)
