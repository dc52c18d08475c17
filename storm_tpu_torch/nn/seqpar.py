"""Sequence parallelism: NCSN++ activations split along the frame axis
(T, the last axis of NCHW) over k devices, with explicit halo exchange and
cross-shard reductions (the counterpart of what XLA's SPMD partitioner
inserts for the reference's `spec_sharding_constraint`,
storm_tpu/models/base.py:156-183).

A `Sharded` activation is k tensors (B, C, F, T_i), part i on device i of
its group (a device may repeat: k shards on one card), and the `FramePlan`
of its call: the parts' boundaries at every level of the net. The top
level's k widths come from `frame_widths`. Where the coarsest level holds
at least k frames, its frames are split as evenly as they go and scaled by
2^(levels - 1), so that every level's boundaries are exact halvings of the
top's; where it holds fewer, the top level's T frames are split as evenly
as they go. Each deeper level's boundaries are the finer level's halved
and rounded up (ceil(b / 2)). So a part may start on an odd frame, and may
hold no frames at a deep level: a 64-frame bucket over 4 shards of a
7-level net has parts of 1, 0, 1, 0 frames at its sixth level and 1, 0, 0,
0 at its seventh. Parts may be unequal.

The primitives:

- `Sharded.halo_map(fn, halo, scale)`: for each part of the output, at the
  level the op's frame ratio `scale` (1, 2 or 1/2) leads to, `fn` on the
  window of input frames that part reads: the input frames its own frames
  map back to, `halo` more on either side, taken from as many shards as
  that needs (so a part narrower than its halo, or empty at the input's
  level, is still right), zeros past the global edges (the padding the op
  adds itself). The output is cropped to the part's frames, contiguous. A
  stride-2 op's window starts on an even frame (its halo is even), so the
  op keeps the unsharded phase whichever frame the part starts on. An
  output part with no frames is an empty tensor, and `fn` is not called
  for it: nothing is launched (`Sharded.empty_parts` counts them). A "same"
  conv takes a halo of (k - 1) / 2 frames, the FIR resamplers a halo of 2.
- `group_norm_moments`: the group means, then the variances around them,
  over all shards in float32 (the two-pass form of the unsharded GroupNorm;
  nn/layers.GroupNorm then normalizes each shard in float32, one rounding).
  An empty part adds no count and no sum.
- `attention_gathered`: each shard's queries against every shard's keys
  and values, gathered in frame order, so that each logit is the dot
  product of the unsharded attention. An empty part has no queries.
- Elementwise ops (arithmetic with scalars, per-row tensors or another
  `Sharded` of the same boundaries, the activations, dropout, `.to(dtype)`)
  run per part, and PyTorch launches nothing for an empty one; `torch.cat`
  joins channels (dim 1) per part. Any other torch function on a `Sharded`
  raises NotImplementedError: nothing falls back to a gathered tensor
  unseen.

The layers dispatch on a `Sharded` input themselves (nn/layers.py,
nn/qconv.py); a layer's parameters for part i are those of the replica of
the net that part i's device holds (`ShardContext.module`).
"""
from __future__ import annotations

import copy
import operator
from typing import Callable, Dict, List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .cast import scalar


def frame_widths(T: int, levels: int, k: int) -> List[int]:
    """The k shards' widths at the top level of a net of `levels` levels on
    T frames (module docstring): the coarsest level's T / 2^(levels - 1)
    frames split as evenly as they go (the first shards one frame wider),
    each scaled by 2^(levels - 1), where there are at least k of them; else
    the T frames split as evenly as they go."""
    f = 2 ** (levels - 1)
    if T % f:
        raise ValueError(f"{T} frames do not halve {levels - 1} times")
    n, scale = (T // f, f) if T // f >= k else (T, 1)
    base, extra = divmod(n, k)
    return [(base + (i < extra)) * scale for i in range(k)]


class FramePlan:
    """The shard boundaries at every level of a net: the top level's from
    its widths, each deeper level's the finer one's halved and rounded up.
    A level is named by its frame count (T / 2^level)."""

    def __init__(self, widths: Sequence[int], levels: int):
        bounds = [0]
        for w in widths:
            bounds.append(bounds[-1] + w)
        self._bounds: Dict[int, Tuple[int, ...]] = {}
        for _ in range(levels):
            self._bounds[bounds[-1]] = tuple(bounds)
            bounds = [-(-b // 2) for b in bounds]

    @classmethod
    def of(cls, T: int, levels: int, k: int) -> "FramePlan":
        """The plan of k shards of a `levels`-level net on T frames."""
        return cls(frame_widths(T, levels, k), levels)

    def bounds(self, frames: int) -> Tuple[int, ...]:
        """The k + 1 boundaries of the level of `frames` frames."""
        if frames not in self._bounds:
            raise ValueError(f"no level of the shard plan holds {frames} frames (its levels "
                             f"hold {sorted(self._bounds, reverse=True)})")
        return self._bounds[frames]

    def widths(self, frames: int) -> List[int]:
        """The parts' widths at the level of `frames` frames."""
        b = self.bounds(frames)
        return [b[i + 1] - b[i] for i in range(len(b) - 1)]


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
    devices of a `ShardContext`, at the boundaries `plan` gives its level
    (module docstring)."""

    __slots__ = ("parts", "ctx", "plan")
    empty_parts = 0  # output parts of `halo_map` that had no frames: nothing launched

    def __init__(self, parts: Sequence[torch.Tensor], ctx: ShardContext, plan: FramePlan):
        self.parts = list(parts)
        self.ctx = ctx
        self.plan = plan

    def _like(self, parts) -> "Sharded":
        return Sharded(parts, self.ctx, self.plan)

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

    def bounds(self) -> Tuple[int, ...]:
        """The parts' boundaries, as the plan gives them at this level."""
        bounds = self.plan.bounds(sum(self.widths))
        if [bounds[i + 1] - bounds[i] for i in range(len(self.parts))] != self.widths:
            raise ValueError(f"shards of widths {self.widths}, where the plan has {bounds}")
        return bounds

    def window(self, i: int, lo: int, hi: int, bounds: Sequence[int]) -> torch.Tensor:
        """The frames [lo, hi) of the whole activation on part i's device,
        from the parts that hold them (at `bounds`), zeros outside [0, T)."""
        p = self.parts[i]
        if (lo, hi) == (bounds[i], bounds[i + 1]):
            return p
        pieces = [p.new_zeros(p.shape[:-1] + (-lo,))] if lo < 0 else []
        for j, q in enumerate(self.parts):
            a, b = max(lo, bounds[j]), min(hi, bounds[j + 1])
            if a < b:
                pieces.append(q[..., a - bounds[j]: b - bounds[j]].to(p.device))
        if hi > bounds[-1]:
            pieces.append(p.new_zeros(p.shape[:-1] + (hi - bounds[-1],)))
        return torch.cat(pieces, dim=-1)

    def halo_map(self, fn: Callable[[int, torch.Tensor], torch.Tensor], halo: int,
                 scale: float = 1.0) -> "Sharded":
        """fn(i, the window part i of the output reads) per non-empty output
        part, each output cropped to the part's frames, contiguous; an empty
        tensor for an empty part (module docstring)."""
        up, down = {1.0: (1, 1), 2.0: (2, 1), 0.5: (1, 2)}[float(scale)]
        src = self.bounds()
        dst = self.plan.bounds(src[-1] * up // down)
        out: List[Union[torch.Tensor, None]] = [None] * len(self.parts)
        for i in range(len(self.parts)):
            start, stop = dst[i], dst[i + 1]
            if start == stop:
                continue
            lo, hi = (start * down) // up - halo, -(-(stop * down) // up) + halo
            if lo * up % down:
                raise ValueError(f"a window from frame {lo} breaks a stride-{down} op's phase")
            y = fn(i, self.window(i, lo, hi, src))
            if y.shape[-1] != (hi - lo) * up // down:
                raise RuntimeError(f"a sharded op gave {y.shape[-1]} frames for a window of "
                                   f"{hi - lo} at scale {scale}")
            offset = start - lo * up // down
            out[i] = like = y[..., offset: offset + stop - start].contiguous()
        for i, y in enumerate(out):
            if y is None:
                out[i] = like.new_empty(like.shape[:-1] + (0,), device=self.ctx.devices[i])
                Sharded.empty_parts += 1
        return self._like(out)

    def apply(self, module: nn.Module, halo: int = 0, scale: float = 1.0) -> "Sharded":
        """`module` (part i's replica of it) by `halo_map`."""
        return self.halo_map(lambda i, t: self.ctx.module(module, i)(t), halo, scale)


# --- cross-shard reductions ------------------------------------------------


def group_norm_moments(x: Sharded, groups: int):
    """(mean, var), each (B, G) float32 on the first part's device: the group
    means over all shards, then the mean squared deviation from them; an
    empty part takes no part."""
    B = x.parts[0].shape[0]
    home = x.parts[0].device
    grouped = [p.reshape(B, groups, -1) for p in x.parts if p.shape[-1]]
    n = sum(g.shape[-1] for g in grouped)
    mean = sum(g.float().sum(dim=-1).to(home) for g in grouped) / n
    var = sum((g.float() - mean.to(g.device)[:, :, None]).square().sum(dim=-1).to(home)
              for g in grouped) / n
    return mean, var


def attention_gathered(q: Sharded, k: Sharded, v: Sharded) -> Sharded:
    """Single-head attention of each shard's queries over every position of
    the unsharded activation, with the unsharded AttnBlockpp's roundings:
    the logits in the compute dtype times C^-0.5 in it, the softmax in
    float32, its weights rounded before the second product. An empty part
    has no queries: its output is the part itself."""
    out = []
    for qi in q.parts:
        if not qi.shape[-1]:
            out.append(qi)
            continue
        B, C = qi.shape[:2]
        dev = qi.device
        keys = gather(k.parts, dev, -1).reshape(B, C, -1)
        values = gather(v.parts, dev, -1).reshape(B, C, -1)
        logits = torch.einsum("bcq,bck->bqk", qi.reshape(B, C, -1), keys) \
            * scalar(int(C) ** (-0.5), qi.dtype)
        w = torch.softmax(logits.float(), dim=-1).to(qi.dtype)
        out.append(torch.einsum("bqk,bck->bcq", w, values).reshape(qi.shape))
    return q._like(out)
