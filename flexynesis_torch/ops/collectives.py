"""The data axis of a single-model fit: one process per device, one global batch.

JAX's data-parallel fit (``flexynesis_tpu/train/trainer.py`` with a ``data``
mesh) is the global-batch program that XLA partitions: BatchNorm statistics
over the whole batch, one loss, one gradient. The port runs one process per
device over a ``torch.distributed`` group (``parallel/distributed.py``) and
keeps those semantics:

* every rank holds the same data, draws the same batch order and sees the
  global batch; inside ``forward_rows`` it forwards a contiguous slice of
  the forward's rows (``split_rows``), and the per-row draws made there
  (dropout masks, the VAE's eps) are drawn at the global shape and sliced
  (``row_draw``), so rank r's rows get the numbers one process would give
  them;
* BatchNorm's training statistics are all-reduced: the row sums and the
  sums of squares (``global_moments``; every rank knows the global row
  count), differentiably, so the backward carries every row's share of the
  statistics' gradient;
* kernel B1 cannot split its rows (its statistics are inside the kernel), so
  a fused block gathers its input rows, runs on the global batch and keeps
  its own rows (``gather_rows``; the backward sums the ranks' gradients of
  the gathered rows onto their owners), as XLA runs a ``pallas_call`` it
  cannot partition on the whole batch;
* the forward's per-row outputs are gathered (``gather_outputs``, the other
  ranks' rows detached) and every rank computes the full loss; a tensor the
  loss reads directly (the Kendall weights under ``log_vars``) keeps its
  gradient on rank 0 only, so the all-reduced sum of the ranks' gradients
  (``all_reduce_grads``) is the global batch's gradient, before the clip.

With a group of one rank every collective is the identity and the fit is
the fit without a group, bit for bit.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional

import torch
import torch.distributed as dist

_STATE = threading.local()


def split_rows(n: int, parts: int) -> List[slice]:
    """``parts`` contiguous slices of ``n`` rows, sizes differing by at most
    one, the larger first."""
    base, extra = divmod(n, parts)
    out, start = [], 0
    for i in range(parts):
        size = base + (1 if i < extra else 0)
        out.append(slice(start, start + size))
        start += size
    return out


class _Axis:
    """The live data axis: the group, this rank and its slice of the rows of
    the forward being run (None outside ``forward_rows``)."""

    def __init__(self, group):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.rows: Optional[slice] = None
        self.total = 0


def current() -> Optional[_Axis]:
    return getattr(_STATE, "axis", None)


@contextlib.contextmanager
def data_axis(group=None):
    """The data axis over ``group`` (the default group) while the block
    runs: a training step's forward and backward."""
    prev = current()
    _STATE.axis = _Axis(group if group is not None else dist.group.WORLD)
    try:
        yield _STATE.axis
    finally:
        _STATE.axis = prev


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _gather(t: torch.Tensor, axis: _Axis, sizes: List[int]) -> torch.Tensor:
    """The ranks' row blocks of ``t`` concatenated (block sizes ``sizes``);
    this rank's block is ``t`` itself, the others detached."""
    pad = max(sizes) - t.shape[0]
    send = t.detach()
    if pad:
        send = torch.cat([send, send.new_zeros((pad, *t.shape[1:]))])
    parts = [torch.empty_like(send) for _ in range(axis.world)]
    dist.all_gather(parts, send.contiguous(), group=axis.group)
    blocks = [t if r == axis.rank else parts[r][:sizes[r]] for r in range(axis.world)]
    return torch.cat(blocks)


class _GatherRows(torch.autograd.Function):
    """All ranks' row blocks of ``t``; the backward sums every rank's
    gradient of the global rows and keeps this rank's block (each rank's
    loss reaches the other ranks' rows through the batch statistics)."""

    @staticmethod
    def forward(ctx, t, axis, sizes):
        ctx.axis, ctx.sizes = axis, sizes
        return _gather(t.detach(), axis, sizes)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.axis.group)
        start = sum(ctx.sizes[:ctx.axis.rank])
        return grad[start:start + ctx.sizes[ctx.axis.rank]], None, None


def _row_sizes(axis: _Axis, multiple: int = 1) -> List[int]:
    return [(s.stop - s.start) * multiple for s in split_rows(axis.total, axis.world)]


def in_rows() -> Optional[_Axis]:
    """The data axis where a forward's rows are split, else None."""
    axis = current()
    return axis if axis is not None and axis.rows is not None else None


def forward_rows(fn, x: dict):
    """``fn`` on this rank's contiguous slice of the rows of every tensor of
    ``x`` (a dict of (R, ...) tensors), its outputs gathered back to R rows
    (``gather_outputs``); just ``fn(x)`` outside the data axis."""
    axis = current()
    if axis is None:
        return fn(x)
    total = next(iter(x.values())).shape[0]
    if total < axis.world:
        raise ValueError(f"a batch of {total} rows cannot split over {axis.world} ranks")
    rows = split_rows(total, axis.world)[axis.rank]
    axis.rows, axis.total = rows, total
    try:
        out = fn({k: v[rows] for k, v in x.items()})
        return gather_outputs(out, axis)
    finally:
        axis.rows = None


def gather_outputs(out, axis: _Axis, key: str = ""):
    """A forward's output tree with its per-row tensors gathered to the
    global rows (this rank's rows keep their gradient); the tensors under
    ``log_vars`` (parameters the loss reads directly) keep their gradient
    on rank 0 only."""
    if isinstance(out, dict):
        return {k: gather_outputs(v, axis, k if key == "" else key) for k, v in out.items()}
    if key == "log_vars":
        return out if axis.rank == 0 else out.detach()
    return _gather(out, axis, _row_sizes(axis))


def row_draw(draw, shape) -> torch.Tensor:
    """``draw(shape)`` of a per-row draw: inside ``forward_rows``, drawn for
    the global rows and sliced to this rank's, so its numbers are those one
    process draws for these rows (a shape of m x the local rows, a GNN's
    rows x nodes, takes m x the global rows)."""
    axis = in_rows()
    if axis is None:
        return draw(tuple(shape))
    local = axis.rows.stop - axis.rows.start
    if shape[0] % local:
        raise ValueError(f"a draw of {shape[0]} rows is not a multiple of this rank's "
                         f"{local} rows")
    m = shape[0] // local
    full = draw((axis.total * m, *tuple(shape)[1:]))
    return full[axis.rows.start * m: axis.rows.stop * m]


def global_moments(h: torch.Tensor):
    """(mean, mean of squares) of ``h`` over its rows (axis -2), over every
    rank's rows inside ``forward_rows``: the sums and the sums of squares are
    all-reduced in one collective; the global row count is every rank's
    (the forward's rows, or m x them for a GNN's rows x nodes)."""
    axis = in_rows()
    n = h.shape[-2]
    if axis is None:
        return h.sum(dim=-2) / n, (h * h).sum(dim=-2) / n
    n = n // (axis.rows.stop - axis.rows.start) * axis.total
    sums = _AllReduceSum.apply(torch.cat([h.sum(dim=-2), (h * h).sum(dim=-2)], dim=-1),
                               axis.group)
    H = h.shape[-1]
    return sums[..., :H] / n, sums[..., H:] / n


def gather_rows(x: torch.Tensor):
    """(the global rows of ``x``, this rank's slice of them) inside
    ``forward_rows``, differentiably: the backward sums the ranks' gradients
    of the global rows onto their owners (``_GatherRows``); (x, None)
    outside."""
    axis = in_rows()
    if axis is None:
        return x, None
    local = axis.rows.stop - axis.rows.start
    m = x.shape[0] // local
    sizes = _row_sizes(axis, m)
    return _GatherRows.apply(x, axis, sizes), slice(axis.rows.start * m, axis.rows.stop * m)


def all_reduce_grads(grads, params) -> list:
    """The ranks' gradients summed (None as zeros), in one flat collective,
    on the data axis; as they are outside it."""
    axis = current()
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
    if axis is None:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=axis.group)
    out, start = [], 0
    for g in grads:
        # a tensor of its own, as autograd gives it: a view into the flat
        # buffer may start unaligned, and the optimizer's multi-tensor
        # kernels then sum its norm in another order on the card
        out.append(flat[start:start + g.numel()].view_as(g).clone())
        start += g.numel()
    return out
